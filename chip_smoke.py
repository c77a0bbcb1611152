#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU: the LOOPS
SpMM paths, its autotuner, the dense LMs' server (llama3.2-1b, on one
device and on a mesh, and qwen3-32b, granite-34b and internlm2-20b), the
MoE LMs' server (qwen3-moe-30b-a3b and qwen2-moe-a2.7b), the ssm LM's
server and trainer (rwkv6-3b) and the llama3.2-1b trainer.

Run from the repository root, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (one JSON line each, ``{"phase": ...}``):

  1. env      -- card name and power limit, toolchain, the kernels' build
                 (``nvcc`` for sm_90a from ``src/repro_torch/csrc``) and its
                 time;
  2. kernels  -- the CUDA kernels B1 (CSR part), B2 (BCSR part), B3 and B4
                 (their value gradients, the SDD kernels) against their
                 plain PyTorch versions on the card: fp32, fp64, bf16, f16
                 (and fp32 cotangents against half operands for B3/B4);
                 adversarial panel shapes, batch 1/3/11, N 32/40/600, the
                 fused buffer with a row offset, and B4 reading the whole
                 cotangent with a row offset against the zero-padded rows;
                 B1/B2 at their uploaded unit tables and at tables that
                 force splits (U = 1, 2, 3 panels), plus a hub case whose
                 row and block-row span more than 50 units, with the split
                 block-row right after the boundary of the fused buffer;
                 and B5 (flash attention) at the reference test's three
                 shapes, a ragged S of 1000 (hd 64 and 128), the mesh
                 ranks' shapes, the dense family's hd-128 head layouts
                 (phase 18's, and theirs on a (1, 2) mesh), the moe
                 family's 32 / 4 and 16 / 16 at phase 20's S of 2048, and
                 the serving shape (4, 2048, 32 heads, 8 kv heads, hd 64),
                 causal and not, fp32 / bf16 / f16; B5 at the reference
                 attention's contract (``FLASH_CONTRACT``, bf16 and fp32,
                 with its lse): hymba-1.5b's 25 heads on 5 at S 4096 with
                 windows 2048, 16 and 100, a prefix offset (Sq 512 on Sk
                 2560), whisper-small's non-causal cross-attention (448 on
                 1500), phi-3-vision's hd 96 and causal Sk < Sq (rows no
                 key may see), each timed in bf16 beside SDPA where SDPA
                 computes the same function (an explicit mask for a window
                 or an offset) and the bound of the kept pairs; wkv6 (the
                 RWKV-6 recurrence) at head size 64 at the serving prefill
                 (4 x 2048, 40 heads, zero start), one decode step from a
                 state, an odd T and 16 CTAs, its state written in place;
                 wkv6_bwd (its backward) at the training shape (4 x 2048,
                 40 heads, from zero) and at an odd T from a state with a
                 final-state cotangent, from the forward kernel's
                 snapshots, two calls bitwise equal; and each of B1-B5,
                 wkv6 and wkv6_bwd through its ``torch.ops.repro_torch``
                 operator (``kernels/_ops.py``): one operator call and one
                 launch a wrapper call, two calls bitwise equal;
  3. main     -- ``plan_and_convert`` -> ``loops_spmm`` at the published
                 sizes of pwtk (m6, 200k rows) and in-2004 (m4, 1.4M rows),
                 N=32, checked against the flat PyTorch path on the card
                 and against a second call (bitwise equal), with each
                 kernel's unit counts and workspace bytes and CUDA-event
                 times of the whole call, of each kernel, of
                 its plain version and of cuSPARSE (``torch.sparse``), and
                 the bound from the bytes and operations the call needs;
                 at m4 fp32 also B3 alone on the CSR part (its hub rows),
                 after the launch counts are read: against its plain
                 version and a second call, with its block table's counts,
                 bound and ``torch.sparse.sampled_addmm`` as the yardstick;
  4. tune     -- the autotuner (``repro_torch.tune``) at m6 and m4, fp32,
                 N=32, in a fresh ``$REPRO_TUNE_CACHE``: a miss whose search
                 measures its ``TUNE_TOP_K`` survivors on the card (none
                 failing; CUDA-event runs of calls) and then the model's
                 plan unless a survivor converts alike, an exact hit with
                 no measurement, a near hit
                 (the same generator across a quantisation edge of the row
                 count) promoted to its own key, the tuned ``loops_spmm``
                 against the flat path and a second call and timed beside
                 the default plan's in turns (``TUNE_TIMING_ROUNDS`` each;
                 not slower beyond the readings' spread unless it is the
                 default's conversion); at m6 a ``TraceRecorder`` on the
                 search, a second search ranked by replay from its
                 records, and dB through ``fmt.transposed(tuner=...)``
                 against the flat path's autograd; an ``Obs`` capture over
                 the phase whose dispatch counts equal the B1/B2 launches
                 and whose ``tune.cache.*`` gauges equal the cache's stats,
                 written as JSONL and Chrome trace and read back;
  5. gcn      -- the 2-layer GCN at ogbn-arxiv's published widths answering
                 three requests, checked against the flat PyTorch path;
  6. train_gcn -- the paper's §4.5 workload: that GCN trained by plain SGD
                 (``examples/gcn_train.py``'s loss) for ``GCN_TRAIN_STEPS``
                 steps through B1/B2 forward and B1/B2 on the transposed
                 adjacency backward; the step-1 gradients of ``w0``/``w1``
                 and the loss trajectory against the flat path's autograd;
                 the transposed build's time, ms per step, and one step's
                 kernels by device time (``torch.profiler``);
  7. train_ffn -- one weight-sparse linear layer at llama3.2-1b's MLP
                 up-projection shape (8192 x 2048, 90% pruned) on a
                 (2, 1024, 2048) activation, fp32 and bf16: the value and
                 activation gradients (B3/B4 and B1/B2 on the transposed
                 weight) against the flat path's autograd, a few SGD steps,
                 B3/B4 timed alone (two calls bitwise equal) with their
                 bounds, TFLOP/s, share of the bound and
                 ``torch.sparse.sampled_addmm`` as the yardstick, and one
                 step's kernels by device time;
  8. serve_lm -- llama3.2-1b at full width (16 layers, d 2048, 32 heads,
                 8 kv heads, vocab 128,256) in bf16 with seeded random
                 weights, serving 4 requests of 2048 prompt + 32 generated
                 tokens (greedy) through ``ServeQueue`` and its
                 ``ExecutorPool`` (the bucket's prefill and decode captured
                 as CUDA graphs by ``warm()`` before traffic, then
                 replayed): the warm-up's seconds, buckets and slots,
                 prefill ms, decode ms per step, tokens/s, time to first
                 token, peak memory, B5's launches (16 per prefill replay);
                 the graphed prefill and decode steps against eager
                 ``api.prefill`` / ``api.decode_step`` at the same bucket and
                 cache, in turns; the served (graphed) bf16 greedy tokens
                 against the eager path's (equal) and the plain attention
                 path's (their agreement), teacher-forced; the same model
                 in fp32, one 2048-token prompt and 8 teacher-forced decode
                 steps graphed, eager through B5 and through the plain
                 attention path, and decode(token S | prefill(S)) against
                 prefill(S + 1); B5 alone
                 at the serving shape in bf16 and fp32 (bound, plain
                 version, ``scaled_dot_product_attention`` as the
                 yardstick, TFLOP/s and share of the bound), and at the
                 serving batch without the mask and at hd 128; one prefill
                 call's and one decode step's kernels (eager and replayed)
                 by device time;
  9. serve_obs -- ``python -m repro_torch.launch.serve --obs`` at the same
                 model and batch with 16 generated tokens: the plan-cache
                 warm-up of the 16 layers' pruned FFN weights (layer 0
                 searches on B1/B2, the rest hit, the serving pool installs
                 each distinct key once and a second warm-up none),
                 ``loops_spmm`` at the pool's plan for layer 0 (N=8)
                 against the flat path and a second call, the
                 capture's histograms against the requests and calls, the
                 tokens against a run without obs, and a run with one
                 injected ``serve.step`` fault (retried, counted, the same
                 tokens); prefill, TTFT and tokens/s beside phase 8's;
 10. serve_traffic -- ``repro_torch.benchmarks.serve_traffic`` at phase 8's
                 model and width: the reference's closed-loop load (6
                 clients x 3 rounds of its mixed shapes), batched against
                 sequential, two passes each through one pool: every request
                 completed, batched engine calls <= sequential, each mode's
                 goodput, p50/p99 and TTFT p50/p99, the pool's buckets and
                 slots, B5's launches; then two requests of one bucket in
                 flight at once, which take two slots and emit what each
                 emits alone;
 11. operator_bench -- the paper's operator evaluation
                 (``repro_torch.benchmarks``): ``python -m
                 repro_torch.benchmarks.run --smoke`` on the card in a
                 process of its own, its records validated against the
                 port's bench schema and gated (``perf_gate``, wall columns
                 off) against the committed CPU baseline; Fig. 4 at the
                 published sizes (the block family at the rows that give
                 the published nnz), N=32, fp32 (fp64 cut for the
                 script's budget in PR 26: phase 3 keeps m6 and m4 in
                 fp64, the smoke suite Fig. 4's fp64 records), each
                 ``loops_spmm`` checked against the flat path and timed
                 beside the flat path, cuSPARSE and dense cuBLAS (None where
                 A dense exceeds the budget), with the calibrated plan at
                 m6 once; the batched suite at pwtk's size (batch 1/16,
                 loop / stack / native / ``torch.vmap``, forward and
                 backward, bitwise equal), with each strategy's launches
                 in one call; Table 4 with ogbn-arxiv's row; §4.3's five
                 regimes at 100,000 rows, calibrated on the card; the
                 autotune suite.
 12. train_lm -- LM training: B5 in training alone at llama3.2-1b's layer
                 shape (4, 2048, 32 heads, 8 kv, hd 64), causal, bf16 and
                 fp32 (the kernel's log-sum-exp against the plain
                 version's, the autograd Function's dQ, dK, dV against
                 autograd through the plain forward in fp32, forward /
                 backward / both against ``scaled_dot_product_attention``'s
                 forward and backward, and the serving launch with a null
                 lse); ``repro_torch.launch.train.main`` at full width in
                 bf16, 8 sequences of 2048 tokens in 2 microbatches, 4
                 steps with a checkpoint after step 2, then ``--resume``
                 from that checkpoint for steps 3-4 (bit for bit equal to
                 the uninterrupted run; no final checkpoint in either
                 run), step 0's loss and every gradient
                 leaf through B5 against a plain reference (autograd
                 through the plain attention and a full-logit
                 cross-entropy), with two planted faults that must fail
                 the same limits, the median step, tokens/s, peak memory,
                 the checkpoint's hand-off and write and the restore, and
                 the model-flops share; 30 steps of the reduced llama (the
                 loss falls by more than 0.5); ``examples/train_lm_torch.py``
                 at its defaults (it learns; its kernel logits equal the
                 plain path's at 1e-3) and its model at llama's FFN width
                 (d 2048, d_ff 8192, 32 heads, 90% sparsity, 2 layers, seq
                 512, batch 4: one step's value gradients against the flat
                 path, 3 SGD steps, B1-B5 all launching).
 13. fallback -- the engine's fallback chain (``cuda → torch``), off in
                 every process until a caller opts in: at m6 for the CSR
                 part (``engine.csr_spmm``, B1) and the fused product
                 (``loops_spmm``, B1 and B2), and at the sparse FFN's value
                 gradient (``engine.loops_sdd``, B3 and B4), a fault
                 injected at the chain's first link raises under the
                 default policy; opted in, it degrades once to the flat
                 references (one ``engine.fallback`` count, no kernel
                 launch, the kernel's result within the fp32 tolerance of
                 the summation bound) and raises during a CUDA graph
                 capture; ``validate_loops`` passes on every format this
                 script built itself (phases 2-4, 5-7, 9, 11 and 13) and
                 raises on a planted bad ``tile_cols``;
 14. gcn_example -- ``examples/gcn_train_torch.py`` at its defaults (the
                 reference's: 2048 nodes, degree 8, 300 SGD steps, lr 5)
                 and with ``--autotune``: its 1e-4 gradient check against
                 the dense adjacency, the loss below 0.7 of its start, the
                 second layer's plan a cache hit, ms a step;
 15. table3   -- ``repro_torch.benchmarks.table3_energy``: Table 3's six
                 matrices at Table 2's sizes, fp16, N = 32, a loop of at
                 least 2 s of ``loops_spmm`` and of cuSPARSE between
                 readings of NVML's energy counter, with ``nvidia-smi``
                 power samples beside it: GFLOP/s, mean board W, J a call
                 and GFLOP/s per W, beside the paper's A100 and M4 Pro
                 columns, the idle power, the card's name and power limit.
 16. distributed -- the distributed LOOPS operator
                 (``repro_torch.core.distributed``) on ``DIST_RANKS`` = 4
                 ranks, processes of their own (``spawn``) sharing the one
                 card on gloo (NCCL refuses two ranks on one device), each
                 with a ``file://`` store and a gloo timeout of
                 ``DIST_TIMEOUT_S``: ``make_test_mesh`` (1 x 4),
                 ``shard_loops_auto`` at m6 in a fresh plan cache (a miss,
                 then a hit), ``distributed_spmm`` at m6 fp32 and fp64
                 (N = 32) against the single-device ``loops_spmm`` on the
                 card at the summation bound, two calls bitwise equal, the
                 stacked layout (a ``DTensor``) against the assembled rows,
                 a batch of 3, dB through autograd (assembled and stacked)
                 against the single-device flat path's autograd at |A|ᵀ·|dY|
                 and bitwise equal on every rank; m4 fp32 forward; and
                 ``compressed_psum`` on 1 << 22 fp32 elements a rank
                 (int8 / bf16 / none within 2e-2 / 1e-2 / 1e-6 of the exact
                 sum, bitwise equal on every rank, the ``dist.collective_
                 bytes`` gauge at n + 4n/D, 2n and 4n, a ``dist.psum.int8``
                 fault on rank 0 raising on every rank by default and
                 degrading every rank to the fp32 sum once opted in); host
                 ms of the forward, backward, single-device call and the
                 collectives alone, with the backend, ``nvidia-smi``'s
                 compute mode, name and power limit.  The ranks share one
                 card: the times are the operator's overhead there, not
                 multi-GPU scaling.  A rank that fails, or a phase past
                 ``DIST_TIMEOUT_S``, fails the run.
 17. train_mesh -- llama3.2-1b at full width and its first
                 ``MESH_LAYERS`` = 4 of 16 layers (the launchers'
                 ``--layers``; cut in PR 28 for the script's time limit),
                 trained across a (data 2, model 2) mesh:
                 first the single-device ``build_train_step`` in this
                 process, one step on the global batch (4 x 2048 tokens,
                 bf16, the launcher's seed, data and schedule); then
                 ``launch/train.py --mesh-data 2 --mesh-model 2`` at full
                 width, which spawns its 4 ranks (sharing the card on gloo),
                 for 2 steps with a checkpoint after step 0, and again with
                 ``--resume`` from it (neither writes a final checkpoint:
                 ``--no-final-ckpt``).  Step 0's loss within
                 ``MESH_LOSS_TOL`` and gradient norm within
                 ``MESH_GNORM_TOL`` (relative) of the single-device step's;
                 every parameter of the checkpoint (the gathered, unsharded
                 tree after one step) within ``MESH_LEAF_TOL`` of its norm
                 from the single-device one; the resumed step's loss and
                 gradient norm bit-equal to the uninterrupted run's on every
                 rank; B5 launched on every rank at 16 local heads, 2 x 16 a
                 step at that depth.  Then serving through
                 ``launch/serve.py`` (the same ``--layers``) and its
                 ``ServeQueue``, on one device here (the graphed pool) and
                 with ``--mesh-data`` / ``--mesh-model`` (spawned ranks,
                 rank 0 scheduling, eager steps): at (1, 2) in fp32, 2
                 requests of 256 + 4 tokens, every logits row within
                 ``LM_TOL`` of one device's and the streams equal; at (2, 2)
                 in bf16, 4 requests of 256 + 16 tokens, every rank's
                 streams equal rank 0's, with the first position where they
                 differ from one device's, decode ms a step and tokens/s;
                 B5 once a layer per prefill on every rank.  First, in this
                 process, one layer's row-parallel ``wo`` GEMMs at a rank's
                 shapes, with fp32 output and with fp32 operands.  It
                 prints step ms per rank, tokens/s, peak GB per rank, the
                 checkpoint's hand-off / write / restore s, the serving
                 numbers, the ``wo`` ms and the card's name and power
                 limit.  A rank that fails fails the run, and so do ranks
                 still running at ``MESH_LIMIT_S`` (every rank is killed).
 18. serve_dense -- the dense family's other configs served in bf16
                 through ``ServeQueue`` and its graphed pool (the bucket
                 warmed first), 4 requests of 2048 + 32 tokens, greedy:
                 qwen3-32b at full width and depth (64 layers, d 5120, 64
                 heads on 8 kv heads, hd 128, qk-norm, an untied 152,064-row
                 vocabulary; 32.8B parameters, 65.5 GB), and granite-34b
                 (48 heads on 1 kv head) and internlm2-20b (48 on 8) at full
                 width, 4 layers each: init s, prefill ms, TTFT, decode ms
                 a step, tokens/s and peak GB (qwen3 below 80 GB), B5 once a
                 layer per prefill replay, and each served stream equal to
                 the eager path's (teacher-forced); then qwen3-32b's
                 config at 2 layers in fp32, one 2048-token prompt and 4
                 decode steps, its logits through B5 against the plain
                 attention path at ``LM_TOL``.
 20. serve_moe -- the moe family served as phase 18 serves (it runs
                 before phase 19): qwen3-moe-30b-a3b at full width and
                 depth (48 layers, d 2048, 32 heads on 4 kv heads, hd 128,
                 qk-norm, 128 experts top 8 of d_ff 768, vocab 151,936
                 untied; 30.5B parameters, 61.1 GB), below 80 GB, and
                 qwen2-moe-a2.7b at full width (16 heads on 16 kv, 60
                 experts padded to 64 plus 4 shared, top 4), 4 of its 24
                 layers; then both configs at 2 layers in fp32, one
                 2048-token prompt and 4 decode steps through B5 and
                 through the plain attention path, the plain run taking
                 the B5 run's routes: every call's logits are held to
                 ``LM_TOL``, and at most ``MOE_FLIP_LIMIT`` of the routed
                 rows (layer x token) may be ones where the plain path's
                 own top-k picks other experts.
 21. serve_ssm -- the ssm family served as phase 18 serves (it runs
                 before phase 19): rwkv6-3b at full width and depth (32
                 layers, d 2560, 40 heads of 64, d_ff 8960, vocab 65,536
                 untied; 3.10B parameters, 6.20 GB), 4 x (2048 + 32)
                 greedy in bf16 through the graphed pool: init s, prefill
                 ms, TTFT, decode ms a step against its floor (every
                 weight and the state read once, the state written once,
                 at 3.35 TB/s), tokens/s, peak GB, wkv6 once a layer per
                 prefill replay and per decode step and B1-B5 never, the
                 streams equal to the eager path's, an eager decode step
                 and prefill profiled; wkv6 alone at the serving prefill's
                 shape (its plain loop, its bound; no library call computes
                 it) and at a decode step's; then its 2 layers in fp32, one
                 2048-token prompt and 4 decode steps through wkv6 and
                 through the recurrence's plain loop (``backend="torch"``):
                 every call's logits at ``LM_TOL``.
 22. train_ssm -- the ssm family trained (it runs before phase 19):
                 wkv6_bwd alone at the training microbatch (4 x 2048, 40
                 heads of 64; its time, its plain version's, its bound;
                 no library call computes it) beside the forward with and
                 without snapshots; step 0 of rwkv6-3b at full width and 2
                 layers in fp32 on 1 x 512 tokens through wkv6 / wkv6_bwd
                 against ``backend="torch"`` (the recurrence's plain loop,
                 differentiated by autograd): loss, gradient norm and
                 every leaf within ``SSM_*_TOL``; the witness of the
                 loss path: the launcher's 3 AdamW steps at those 2 layers
                 in bf16 on 8 x 256 tokens through wkv6 / wkv6_bwd and
                 through the plain loop, each step's loss within
                 ``SSM_WITNESS_TOL``; then
                 ``repro_torch.launch.train.main`` at full width and 16 of
                 its 32 layers (``--layers 16``; 1.72B parameters), bf16,
                 8 sequences of 2048 tokens in 2 microbatches, AdamW, 3
                 steps with a checkpoint after step 1 and a ``--resume``
                 from it whose step 2 equals the uninterrupted run's bit
                 for bit; the median step, tokens/s, model-flops share,
                 peak GB (below 80), the checkpoint's hand-off / write and
                 the restore; wkv6 twice (forward and the checkpoint's
                 recompute) and wkv6_bwd once a layer and microbatch, B1-B5
                 never.
 19. dryrun   -- the production-mesh dry-run (``repro_torch.launch.dryrun``)
                 on fake CUDA tensors over a fake process group, in three
                 processes at once: llama3.2-1b's ``train_4k``,
                 ``prefill_32k`` and ``decode_32k`` cells on (16, 16) and
                 qwen3-32b's, qwen3-moe-30b-a3b's and rwkv6-3b's
                 ``decode_32k`` on (2, 16, 16), each ``ok``
                 with its per-device flops, HBM bytes, collective bytes by
                 kind, memory record, three roofline terms (an H100's
                 published peaks) and trace s; ``benchmarks/spmm_dryrun``
                 at full size (1.4M rows over 256 ranks; the traced CSR and
                 BCSR ranks' flops equal 2 x their lanes x N); and
                 ``benchmarks/compress_bytes`` (int8 >= 3x and bf16 2x fewer
                 bytes than fp32).  Nothing launches (B1-B5 and wkv6
                 counted).

Each kernel's launch count is set to 0 just before phases 3-18 and 20-22
drive their path and read just after; a kernel of a path that did not
launch fails the run, and so does a launch of a kernel that is not on the
path (B5 in phases 3-7, 13-16, 21 and 22, B1-B4 in phases 8, 10, 18 and
20-22 and in the LM runs of phases 12 and 17, B3/B4 in phases 9, 14, 15
and 16, B3-B5 in phase 11, wkv6 in every phase but 21 and 22, wkv6_bwd in
every phase but 22).
In phase 16 each rank counts its own launches, the forward apart from the backward: in the
forward a CSR-group rank launches B1 alone and a BCSR-group rank B2 alone,
once a call; in the backward each launches B1 / B2 once a call for each
part of its chunk's transposed format; the kernels line adds every rank's
counts.  In phase 12 B5
launches twice a layer and microbatch in a train step (the forward and
the remat recompute; its backward is PyTorch, no launch).  A replayed CUDA
graph adds the launches it captured (``repro_torch.dist.step``), and each
slot the pool builds runs its prefill once eagerly before the capture, so
B5 counts 16 launches per prefill replay and per slot built.  The last
two lines are ``{"kernels": [...]}`` and ``{"ok": true, "device":
{...}}``.  Any failed check exits non-zero with no result.  ``--out DIR``
also writes the full record to ``DIR/chip_smoke.json`` and phases 4 and
9's obs captures (JSONL and Chrome trace) beside it.

Tolerances: fp32 1e-5, fp64 1e-12, bf16/f16 1e-2 (the sums run in another
order; half inputs are exact in the fp32 accumulator).  In phase 2 they
bound max |kernel - plain| / max(1, max |plain|).  At the published sizes a
hub row sums ~1e5 products, so phase 3 bounds the error of each element by
the summation bound instead: |kernel - plain| / max(1, (|A|·|B|)) <= tol.
The GCN's logits: 1e-4 of max(1, max |logits|) in fp32 (two aggregations and
two matmuls deep).  Gradients (phases 4, 6 and 7) are bounded per element by
their own summation bound, the same products on magnitudes: in phase 7
|dY|·|B| for the values and |W|ᵀ·|dY| for the activation, at the dtype's
tolerance (bf16 1e-2: the kernel path casts dY to bf16 before dx, as the
reference does); in phase 6 the chain of |Â|ᵀ, |h|, |w1| and |x| products at
``GCN_TOL``, four SpMMs and four matmuls deep, with relu's mask taken as
all-ones (it may flip where an activation is within rounding of 0), and the
reference example's own check, max |g - g_flat| <= 1e-4.  B5 against its
plain version: 2e-5 in fp32 (the reference kernel test's) and 1e-2 in half
(both accumulate in fp32; the kernel rounds P to the half dtype before P·V,
as scaled_dot_product_attention does, and both round the output once), of
max(1, max |plain|); and, since a long row's output is ~1e-2 of that
scale, each output row within ``FLASH_ROW_TOL`` of its own norm (fp32
1e-4, bf16 1.5e-2, f16 3e-3).  The LM's fp32 logits, B5 path against the
plain attention path and decode against prefill: ``LM_TOL`` = 1e-4 of
max(1, max |logits|), as the GCN's; the two paths differ only in the order
of attention's fp32 sums (~1e-7 relative), carried through 16 layers and a
2048-wide head, which leaves the logits ~1e-6 apart.  Phase 12: B5's
log-sum-exp within ``LSE_TOL`` = 1e-5 of max(1, max |lse|) (fp32 statistics
in both); its gradients each row within ``FLASH_ROW_TOL`` of the fp32
oracle's row norm (:func:`grad_row_err`, rows at 1e-3 of the largest row's
norm floored there); the full-width step 0 on B5 against the plain
reference: loss ``TRAIN_LOSS_TOL`` = 1e-4 relative, gradient norm
``TRAIN_GNORM_TOL`` = 1e-3 relative, each leaf ``TRAIN_LEAF_TOL`` = 3e-2 of
its norm (bf16 activations rounded apart through 16 layers; measured
1.9e-5, 4.3e-5 and 1.25e-2); the sparse-FFN value gradients within
the fp32 tolerance of their summation bound, as phase 7.  Phase 13: a
degraded call against the kernel's, each element within the fp32
tolerance of its summation bound.  Phase 14: the example's own gradient
check, max |g_loops - g_dense| <= 1e-4.  Phase 16: the forward against
the single-device ``loops_spmm`` at the dtype's tolerance of |A|·|B|, dB
against the flat path's at that of |A|ᵀ·|dY|, as phase 3.  Phase 15: ``loops_spmm`` in fp16
against the flat path, 1e-3 of max(1, max |flat|) (both accumulate exact
products in fp32).  wkv6 against its plain loop (phases 2 and 21): each
element of y and of the final state within ``WKV6_TOL`` = 1e-5 of the same
recurrence run on magnitudes (|r|, |k|, |v|, w, |u|, |s0|), which bounds
the fp32 sums' size at every step; the two differ in the order of those
sums (the kernel adds the bonus term as one scalar a step).  wkv6_bwd
against its plain reverse loop (phases 2 and 22): each gradient element
within ``WKV6_TOL`` of the same derivative run on magnitudes.  B5 at the
contract's cases: ``FLASH_TOL``, ``FLASH_ROW_TOL`` and ``LSE_TOL`` as
above.  Phase 22's step 0, the two fp32 paths differing only in the
order of their sums: loss and gradient norm 1e-5 relative, each leaf 1e-4
of its norm; its witness, 3 bf16 steps through the kernels and the plain
loop: each step's loss within ``SSM_WITNESS_TOL`` = 2e-2 relative.
TF32 is off, and so are cuBLAS's reduced-precision bf16 reductions.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense): 3.35 TB/s HBM3; 67 TFLOP/s
# fp32 on the CUDA cores (this path uses no TF32); 67 TFLOP/s fp64 on the
# tensor cores; 989 TFLOP/s bf16/f16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12, "float16": 989e12,
              "bfloat16": 989e12}
TOL = {"float32": 1e-5, "float64": 1e-12, "float16": 1e-2, "bfloat16": 1e-2}
GCN_TOL = 1e-4

# (matrix id, published rows, dtypes) of the main path; N is the paper's
# fixed width (benchmarks/fig4_throughput.py).
MAIN_MATRICES = (("m6", 200_000, ("float32", "float64", "float16")),
                 ("m4", 1_400_000, ("float32", "float64")))
MAIN_N = 32
# (matrix, dtype) of the main path at which B3 is timed alone on the CSR
# part: in-2004's hub rows, where no two rows share columns.
B3_MAIN = ("m4", "float32")
# ogbn-arxiv: 169,343 nodes, ~1.17M edges (avg degree ~7), 128 features,
# 40 classes; 256 hidden is OGB's GCN baseline width.
GCN_NODES, GCN_DEGREE, F_IN, F_HID, F_OUT = 169_343, 7, 128, 256, 40
# examples/gcn_train.py's learning rate; about 20 steps of the §4.5 loop.
GCN_TRAIN_STEPS, GCN_LR = 20, 5.0
# llama3.2-1b (src/repro/configs/llama3_2_1b.py): d_model 2048, d_ff 8192;
# the MLP up-projection is (d_ff, d_model).  90% magnitude pruning, applied
# to a (batch 2, 1024 tokens, d_model) activation.
FFN_D_OUT, FFN_D_IN, FFN_SPARSITY = 8192, 2048, 0.9
FFN_X_SHAPE = (2, 1024, 2048)
FFN_DTYPES = ("float32", "bfloat16")
FFN_STEPS, FFN_LR = 3, 1e-4

# llama3.2-1b (src/repro/configs/llama3_2_1b.py) at full width, served:
# 4 requests of 2048 prompt tokens and 32 generated tokens, greedy; the
# fp32 check decodes 8 teacher-forced tokens after one 2048-token prompt.
LM_ARCH, LM_SEED = "llama3.2-1b", 0
LM_BATCH, LM_PROMPT, LM_GEN, LM_CHECK_STEPS = 4, 2048, 32, 8
LM_TOL = 1e-4

# Phase train_mesh: the launcher's arguments (its config at full width,
# cut to MESH_LAYERS of its 16 layers for the script's time limit since
# PR 28), the mesh, the
# global batch, steps and the checkpoint (after step 0: ckpt_1), the
# tolerances against the single-device step (bf16 activations rounded apart
# in another order, the tensor-parallel sums in fp32): phase 12's for the
# loss and the gradient norm, and a third of its leaf bound, since a first
# run measured 2.2e-5, 7.8e-5 and 1.9e-3; the (1, 2) serving check's
# shapes, and the phase's wall-clock limit (runs took 224-268 s: gloo's
# host-staged collectives ran up to 3x slower on one machine than another).
MESH_LAYERS = 4
MESH_CLI = ["--arch", LM_ARCH, "--layers", str(MESH_LAYERS)]
MESH_SHAPE, MESH_SEQ, MESH_BATCH = (2, 2), 2048, 4
MESH_STEPS, MESH_CKPT_AT = 2, 1
MESH_LOSS_TOL, MESH_GNORM_TOL, MESH_LEAF_TOL = 1e-4, 1e-3, 1e-2
MESH_PROMPT, MESH_GEN = (2, 256), 4
MESH_LIMIT_S = 400
# Phase train_mesh's serving check through launch/serve.py: (mesh,
# requests, prompt, generated tokens, dtype): fp32 logits at (1, 2), and
# the bf16 model's streams at (2, 2).
MESH_SERVE_FP32 = ((1, 2), MESH_PROMPT[0], MESH_PROMPT[1], MESH_GEN + 1,
                   "float32")
MESH_SERVE_BF16 = (MESH_SHAPE, 4, 256, 16, "bfloat16")

# Phase serve_dense: qwen3-32b at full width and depth (64 layers, d 5120,
# 64 heads on 8 kv heads, hd 128, qk-norm, vocab 151,936 untied; 32.8B
# parameters, 65.5 GB in bf16), served 4 x (2048 + 32) tokens; its first
# DENSE_CHECK_LAYERS layers in fp32 (logits through B5 against the plain
# path); granite-34b (48 heads on 1 kv head) and internlm2-20b (48 on 8)
# at full width, DENSE_CUT_LAYERS layers (95 and 40 GB in bf16 at full
# depth).  DENSE_REDUCED serves the reduced configs (a CPU rehearsal).
DENSE_ARCH, DENSE_CUT = "qwen3-32b", ("granite-34b", "internlm2-20b")
DENSE_BATCH, DENSE_PROMPT, DENSE_GEN = 4, 2048, 32
DENSE_CHECK_LAYERS, DENSE_CHECK_STEPS, DENSE_CUT_LAYERS = 2, 4, 4
DENSE_REDUCED = False

# Phase serve_moe: qwen3-moe-30b-a3b at full width and depth (48 layers, d
# 2048, 32 heads on 4 kv, hd 128, qk-norm, 128 experts top 8, expert
# d_ff 768, vocab 151,936 untied; 30.5B parameters, 61.1 GB in bf16) and
# qwen2-moe-a2.7b at full width (16 heads on 16 kv, 60 experts padded to
# 64 plus 4 shared, top 4), MOE_CUT_LAYERS of its 24 layers, served as
# phase 18 serves; both at MOE_CHECK_LAYERS layers in fp32 through B5
# against the plain attention path, which takes B5's routes so that every
# call's logits are held, with each layer's own routes compared: at most
# MOE_FLIP_LIMIT of the routed rows may flip.  The sizes are phase
# 18's (DENSE_BATCH, DENSE_PROMPT, DENSE_GEN, DENSE_CHECK_STEPS).
MOE_ARCH, MOE_CUT = "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"
MOE_CUT_LAYERS, MOE_CHECK_LAYERS, MOE_FLIP_LIMIT = 4, 2, 0.01

# Phase serve_ssm: rwkv6-3b at full width and depth (32 layers, d 2560, 40
# heads of 64, d_ff 8960, vocab 65,536 untied; 3.10B parameters, 6.20 GB in
# bf16), served as phase 18 serves (DENSE_BATCH x (DENSE_PROMPT +
# DENSE_GEN), greedy, the graphed pool); its SSM_CHECK_LAYERS layers in
# fp32 (1 x DENSE_PROMPT + DENSE_CHECK_STEPS) through wkv6 against the
# recurrence's plain loop at LM_TOL.
SSM_ARCH, SSM_CHECK_LAYERS = "rwkv6-3b", 2
# wkv6 in phase 2: (B, T, H, non-zero s0) at head size 64, the GPU tests'
# shapes: the serving prefill (4 x 2048, 40 heads; the kernels line's),
# one decode step from a state, an odd T, and 16 CTAs on 132 SMs; each
# element within WKV6_TOL of the same recurrence run on magnitudes.
WKV6_SHAPES = ((4, 2048, 40, False), (4, 1, 40, True), (2, 37, 40, True),
               (1, 300, 8, True))
WKV6_TOL = 1e-5
# wkv6_bwd in phase 2: (B, T, H, non-zero s0 and dS_T) at head size 64: the
# training shape (4 x 2048, 40 heads, from zero; the kernels line's) and an
# odd T from a state with a final-state cotangent, from the forward
# kernel's snapshots; each gradient element within WKV6_TOL of the same
# derivative run on magnitudes, two calls bitwise equal.
WKV6_BWD_SHAPES = ((4, 2048, 40, False), (2, 37, 40, True))

# Phase train_ssm: rwkv6-3b at full width and SSM_TRAIN_LAYERS of its 32
# layers (the launchers' --layers: 1.72B parameters, ~41 GB of weights,
# gradients and AdamW state against ~73 GB at full depth), bf16,
# TRAIN_BATCH x TRAIN_SEQ tokens a step in 2 microbatches, AdamW,
# SSM_TRAIN_STEPS steps with a checkpoint after step SSM_CKPT_AT - 1 and a
# resume from it (no final checkpoint); step 0 at SSM_CHECK_LAYERS layers
# in fp32 on 1 x SSM_CHECK_SEQ tokens through wkv6 / wkv6_bwd against
# backend "torch" (the recurrence's plain loop, differentiated by
# autograd): the loss within SSM_LOSS_TOL relative, the gradient norm
# within SSM_GNORM_TOL relative and every leaf within SSM_LEAF_TOL of its
# norm (the same fp32 arithmetic in another order).
SSM_TRAIN_LAYERS, SSM_TRAIN_STEPS, SSM_CKPT_AT = 16, 3, 2
SSM_CHECK_SEQ = 512
SSM_LOSS_TOL, SSM_GNORM_TOL, SSM_LEAF_TOL = 1e-5, 1e-5, 1e-4
# The witness of the training run's loss path: the launcher's SSM_TRAIN_STEPS
# AdamW steps (its optimizer settings, data and seed) at SSM_CHECK_LAYERS
# layers in bf16 on TRAIN_BATCH x SSM_WITNESS_SEQ tokens in 2 microbatches,
# once through wkv6 / wkv6_bwd and once through backend "torch": every
# step's loss within SSM_WITNESS_TOL relative (bf16, as the CPU tests hold
# bf16 losses), so a rise the kernels did not cause shows in both.
SSM_WITNESS_SEQ, SSM_WITNESS_TOL = 256, 2e-2

# B5 in phase 2: (B, S, H, KV, hd); the reference test's three shapes, a
# ragged S, a (2, 2) mesh rank's training shape and a (1, 2) rank's
# prefill in phase 17 (llama3.2-1b's 32 / 8 heads over model 2); the dense
# family's hd-128 layouts of phase 18 -- qwen3-32b 64 / 8, internlm2-20b
# 48 / 8, granite-34b 48 / 1 (rep 48) -- and on a (1, 2) mesh 32 / 4, 24 /
# 4 and granite's 24 / 24 (its whole kv head taken once a q head), with 24
# / 8 and 24 / 1; the moe family's layouts of phase 20 at the S it
# serves, qwen3-moe-30b-a3b's 32 / 4 and qwen2-moe-a2.7b's 16 / 16; and
# the serving shape (last: phase 4 reads its heads).
FLASH_SHAPES = ((1, 64, 1, 1, 16), (2, 128, 4, 2, 32), (1, 64, 6, 2, 16),
                (2, 1000, 8, 2, 64), (1, 1000, 4, 1, 128),
                (MESH_BATCH // MESH_SHAPE[0], MESH_SEQ, 32 // MESH_SHAPE[1],
                 8 // MESH_SHAPE[1], 64),
                (*MESH_PROMPT, 32 // MESH_SHAPE[1], 8 // MESH_SHAPE[1], 64),
                (2, 2048, 64, 8, 128), (2, 2048, 48, 8, 128),
                (2, 2048, 48, 1, 128), (2, 1024, 32, 4, 128),
                (2, 1024, 24, 4, 128), (2, 1024, 24, 24, 128),
                (2, 1024, 24, 8, 128), (2, 1024, 24, 1, 128),
                (2, 2048, 32, 4, 128), (2, 2048, 16, 16, 128),
                (LM_BATCH, LM_PROMPT, 32, 8, 64))
FLASH_TOL = {"float32": 2e-5, "bfloat16": 1e-2, "float16": 1e-2}
# B5 also against each output row's own size (``row_err``).  A long row's
# output is far below max |plain| (~0.03 against ~3 at S 2048), where
# FLASH_TOL is loose; P rounded once to bf16 moves a row by < 7e-3, f16 by
# < 1e-3, and a lost or misplaced K / V tile by 0.3 or more at S 1000 and
# 2049 (tests/test_torch_flash_attention.py models both).
FLASH_ROW_TOL = {"float32": 1e-4, "bfloat16": 1.5e-2, "float16": 3e-3}
# B5 at the reference attention's contract in phase 2 (name, B, Sq, Sk, H,
# KV, hd, causal, window): hymba-1.5b's 25 heads on 5 (rep 5: one head a
# CTA) at S 4096 with its window 2048 and windows 16 and 100 (no multiples
# of the 64-key tile); llama's 32 / 8 at a prefix offset (Sq 512, Sk 2560);
# whisper-small's cross-attention, 12 on 12, its 448 decoder positions on
# its encoder_seq 1500, non-causal; phi-3-vision's 32 on 32 at hd 96; and
# causal Sk < Sq, whose first rows no key may see (checked, not timed).
# Each against the plain version in bf16 and fp32 (FLASH_TOL,
# FLASH_ROW_TOL), and timed in bf16 beside SDPA where SDPA computes the same
# function (with an explicit boolean mask for a window or an offset).
FLASH_CONTRACT = (("hymba_w2048", 1, 4096, 4096, 25, 5, 64, True, 2048),
                  ("hymba_w16", 1, 4096, 4096, 25, 5, 64, True, 16),
                  ("hymba_w100", 1, 4096, 4096, 25, 5, 64, True, 100),
                  ("offset", 4, 512, 2560, 32, 8, 64, True, 0),
                  ("whisper_cross", 4, 448, 1500, 12, 12, 64, False, 0),
                  ("phi3v_hd96", 2, 2048, 2048, 32, 32, 96, True, 0),
                  ("dead_rows", 2, 700, 300, 8, 2, 96, True, 0))
# Phase tune: the autotuner at phase main's matrices (fp32, N = MAIN_N):
# the search's survivors, the replay search's, and the transposed search's.
TUNE_TOP_K, TUNE_REPLAY_TOP_K, TUNE_T_TOP_K = 4, 2, 2
# The tuned plan and the default are each timed this many times, in turns:
# the tuned one must not be slower beyond the readings' spread.
TUNE_TIMING_ROUNDS = 3
# The near-hit matrix: phase main's generator and seed at the row count
# whose log2 lies 0.05 past the quantisation edge nearest phase main's (the
# plan cache buckets features in 0.5-wide bins): a different exact key
# within the near-match distance.  (Another seed does not do at m4: the
# power law's longest row moves with the seed, and a seed-1 in-2004-like
# matrix lay 0.80 away, a miss; PERF.md.)
# Phase serve_obs: the launcher with --obs at phase serve_lm's model and
# batch, 16 generated tokens; one injected serve.step fault in its last run.
OBS_GEN = 16
OBS_FAULT_PLAN = "serve.step:raise:0"

# Phase operator_bench: Fig. 4's dtypes at the published sizes, the matrix
# and dtype whose calibrated plan is timed once, the batched suite's
# batches at pwtk's size, and §4.3's row count.
FIG4_DTYPES = ("float32",)
FIG4_CALIBRATED = ("m6", "float32")
BATCHED_BATCHES = (1, 16)
SEC43_ROWS = 100_000

# Phase train_lm: the launcher at llama3.2-1b's full width (bf16, 4 x 2048
# tokens a microbatch, 2 microbatches), a checkpoint after step 2 and a
# resume from it.  Step 0's first microbatch, grad on, through B5 against
# the plain reference (_plain_train_loss): the loss within TRAIN_LOSS_TOL
# relative, the global gradient norm within TRAIN_GNORM_TOL relative and
# every leaf's gradient within TRAIN_LEAF_TOL of its norm.  The two paths
# round bf16 activations differently through 16 layers; measured on the
# H100: loss 1.9e-5, gradient norm 4.3e-5, worst leaf 1.25e-2 (an
# attention wk).  A K/V tile left out of the lse or of dK/dV moves the
# gradient norm by 0.19-1.0 and a leaf by 0.41-9.0, and the check runs both
# planted faults and requires them to fail.  The lse within LSE_TOL of
# max(1, |lse|) (fp32 statistics, ex2.approx in the half body: measured
# 2e-6); 30 steps of the reduced llama; the example at llama's FFN width.
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_CKPT_AT = 2048, 8, 4, 2
TRAIN_LOSS_TOL = 1e-4
TRAIN_GNORM_TOL = 1e-3
TRAIN_LEAF_TOL = 3e-2
LSE_TOL = 1e-5
REDUCED_STEPS = 30
EX_FFN = {"d_model": 2048, "d_ff": 8192, "heads": 32, "sparsity": 0.9,
          "layers": 2, "seq": 512, "batch": 4, "vocab": 512, "lr": 3e-2}
EX_STEPS = 3

# B1/B2 in phase 2: unit tables that force splits (panels per unit), and
# the width of the hub case's dense rows (> 50 units at U <= 3 and G = 8,
# and at B1's own unit size with G = 1).
SPLIT_UNIT_PANELS = (1, 2, 3)
HUB_K = 2000

# Phase distributed: DIST_RANKS processes share the card, one rank each, on
# gloo (NCCL refuses two ranks on one device); each rank's gloo timeout and
# the phase's wall-clock limit.  m6 fp32 and fp64 (N = MAIN_N; a batch of
# DIST_BATCH right-hand sides), m4 fp32 forward; compressed_psum on
# DIST_PSUM_N fp32 elements a rank (the reference benchmark's shard),
# within the reference test's bounds of the exact sum.
DIST_RANKS = 4
DIST_TIMEOUT_S = 120
DIST_BATCH = 3
DIST_PSUM_N = 1 << 22
DIST_PSUM_BOUND = {"int8": 2e-2, "bf16": 1e-2, "none": 1e-6}

RECORD = {"phases": []}
# Each phase record's ``at_s``: seconds since the script started.
T_START = time.perf_counter()
# The formats validate_loops passed on (``validated``), for phase 13.
VALIDATED = []


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def phase(obj: dict) -> None:
    obj.setdefault("at_s", time.perf_counter() - T_START)
    RECORD["phases"].append(obj)
    emit(obj)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def time_ms(fn, *, samples: int = 10, reps: int = 5, warmup: int = 2) -> float:
    """Median over ``samples`` of the CUDA-event time of ``reps``
    back-to-back calls, divided by ``reps`` (after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def timed_call(fn):
    """``fn()`` once between two device synchronisations: its result and
    the host-clock milliseconds it took (for a plain loop of many small
    launches, whose one call is long enough to time alone)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def device_ms(fn, *, calls: int = 10, sessions: int = 3) -> float | None:
    """Device time of one call of ``fn``: the kernels ``torch.profiler``
    saw in ``calls`` calls, summed and divided by ``calls``, the median of
    ``sessions`` profiling sessions (a session now and then loses kernel
    records); None if it saw none.  Unlike :func:`time_ms` it leaves out
    the host's share of a call (the wrapper's checks and the launch), which
    bounds a call whose kernels take tens of microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    totals = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        totals.append(sum(getattr(e, "self_device_time_total", 0)
                          for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    total = statistics.median(totals)
    return total / 1e3 / calls if total else None


def profile_step(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time (host
    clock around the synchronised call), the device time of the kernels it
    ran, summed by name (the eight longest), and the device's idle share
    of the wall time.  Device numbers are None where the profiler saw no
    kernel (it is untried on the GPU machine)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) if rows else None
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": None if busy is None else 1.0 - busy / wall,
            "kernels": len(rows),
            "top": [{"name": n[:100], "device_ms": ms, "count": c}
                    for n, ms, c in rows[:8]]}


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max(1, max |want|)) in float64."""
    g = got.double()
    w = want.double()
    err = float((g - w).abs().max()) if w.numel() else 0.0
    scale = max(1.0, float(w.abs().max()) if w.numel() else 0.0)
    return err, scale


def row_err(got, want) -> float:
    """max over rows of |got - want| / |want|, the norms over the last
    dimension, in float64 (a zero row of both counts as 0)."""
    if not want.numel():
        return 0.0
    w = want.double()
    d = (got.double() - w).norm(dim=-1)
    return float((d / w.norm(dim=-1).clamp_min(1e-300)).max())


def sum_err(got, want, absprod) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / max(1, absprod)) elementwise,
    where ``absprod`` = |A|·|B| bounds the rounding of each sum."""
    d = (got.double() - want.double()).abs()
    if not d.numel():
        return 0.0, 0.0
    return float(d.max()), float((d / absprod.double().clamp_min(1.0)).max())


def abs_format(fmt):
    """``fmt`` with every stored value replaced by its magnitude."""
    import dataclasses
    import numpy as np
    return dataclasses.replace(
        fmt, csr_part=dataclasses.replace(
            fmt.csr_part, vals=np.abs(fmt.csr_part.vals)),
        bcsr_part=dataclasses.replace(
            fmt.bcsr_part, tile_vals=np.abs(fmt.bcsr_part.tile_vals)))


def bound(*, bytes_moved: float, flops: float, dtype: str) -> dict:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "flops": flops}


def panel_bound(panels, b3, out_elem: int, *, br: int, dtype: str) -> dict:
    """Least time of one panel-kernel call: each input read once (the panel
    arrays, the B rows the panels reference), each output row written once;
    flops of the real (unmasked) lanes."""
    import torch
    n = b3.shape[-1]
    real_cols = panels.cols[panels.mask]
    distinct_rows = int(torch.unique(real_cols).numel())
    elem = b3.element_size()
    meta = (panels.ptr.numel() * 8 + panels.cols.numel() * 4
            + panels.vals.numel() * panels.vals.element_size()
            + panels.mask.numel())
    out_rows = panels.ngroups * br
    nbytes = (meta + b3.shape[0] * distinct_rows * n * elem
              + b3.shape[0] * out_rows * n * out_elem)
    flops = 2.0 * real_cols.numel() * br * n * b3.shape[0]
    return bound(bytes_moved=float(nbytes), flops=flops, dtype=dtype)


def sdd_bound(panels, dy3, b3, out, *, br: int, dy_rows: int,
              dtype: str) -> dict:
    """Least time of one SDD-kernel call: the panel structure, the part's
    ``dy_rows`` cotangent rows and the B rows the panels reference, each
    read once, the panel-layout output written once; flops of the real
    (unmasked) lanes, Br per lane."""
    import torch
    n = b3.shape[-1]
    real_cols = panels.cols[panels.mask]
    distinct_rows = int(torch.unique(real_cols).numel())
    meta = (panels.rows.numel() * 4 + panels.cols.numel() * 4
            + panels.mask.numel())
    nbytes = (meta + b3.shape[0] * dy_rows * n * dy3.element_size()
              + b3.shape[0] * distinct_rows * n * b3.element_size()
              + out.numel() * out.element_size())
    flops = 2.0 * real_cols.numel() * br * n * b3.shape[0]
    return bound(bytes_moved=float(nbytes), flops=flops, dtype=dtype)


def library_sdd_ms(part_csr, dy_rows, bt, dtype) -> tuple[float | None, str]:
    """``torch.sparse.sampled_addmm`` on the part's CSR with the part's
    cotangent rows ``(rows, Z*N)`` and ``Bᵀ`` ``(Z*N, K)``: the same
    batch-summed SDD at the part's real nonzeros, as a yardstick only (the
    port never calls it)."""
    import torch
    try:
        a = torch.sparse_csr_tensor(
            torch.as_tensor(part_csr.row_ptr.astype("int64")).to(DEVICE),
            torch.as_tensor(part_csr.col_idx.astype("int64")).to(DEVICE),
            torch.as_tensor(part_csr.vals).to(DEVICE, dtype),
            size=part_csr.shape)
        m1, m2 = dy_rows.to(dtype), bt.to(dtype)
        ms = time_ms(lambda: torch.sparse.sampled_addmm(a, m1, m2, beta=0.0))
    except RuntimeError as e:   # a dtype the library does not take
        return None, f"n/a: {type(e).__name__}: " \
            f"{str(e).splitlines()[0][:160]}"
    return ms, "torch.sparse.sampled_addmm on the part's CSR (cuSPARSE SDDMM)"


def library_ms(csr, b, dtype) -> tuple[float | None, str]:
    """cuSPARSE through ``torch.sparse_csr_tensor(...) @ B`` on the same
    matrix, as a yardstick only (the port never calls it)."""
    import torch
    try:
        a = torch.sparse_csr_tensor(
            torch.as_tensor(csr.row_ptr.astype("int64")).to(DEVICE),
            torch.as_tensor(csr.col_idx.astype("int64")).to(DEVICE),
            torch.as_tensor(csr.vals).to(DEVICE, dtype), size=csr.shape)
        ms = time_ms(lambda: a @ b)
    except RuntimeError as e:   # a dtype cuSPARSE does not take
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return ms, "torch.sparse_csr_tensor @ dense (cuSPARSE)"


# ---------------------------------------------------------------------------
# phase 1: environment and build
# ---------------------------------------------------------------------------

def phase_env() -> dict:
    import torch
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    check(smi.returncode == 0 and smi_line, f"nvidia-smi failed: "
          f"{smi.stderr.strip()}")
    print(smi_line, flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    RECORD["build_log"] = dict(_build.build_log)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "env", "nvidia_smi": smi_line,
            "device": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "build_s": build_s, "libraries": sorted(p.name for p in
                                                   libs.values())}
    phase(info)
    return info


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _adversarial(rng):
    """Dense matrices whose panelizations hit every padding edge (the
    reference's tests/test_kernels.py::_adversarial_cases), a skewed random
    one with a hub row and empty rows, and a hub case whose rows and
    block-rows span more than 50 units at U <= 3 panels (and at B1's own
    unit size with G = 1), with empty groups on either side.  Returns ``{name:
    (matrix, r_boundary or None)}``; None puts the boundary at half the
    rows, rounded down to a whole block."""
    import numpy as np

    def sparse(m, k, d):
        return (rng.random((m, k)) < d) * rng.standard_normal((m, k))
    cases = {"indivisible": sparse(11, 9, 0.35),
             "single_row": sparse(1, 13, 0.6)}
    hub = np.zeros((5, 24))
    hub[2, :] = rng.standard_normal(24)
    hub[0, 3] = 1.5
    cases["row_spans_panels"] = hub
    short = np.zeros((9, 6))
    for r in range(9):
        short[r, r % 6] = r + 1.0
        if r % 2:
            short[r, (r + 3) % 6] = -1.0
    cases["panel_at_row_boundary"] = short
    skew = sparse(300, 257, 0.03)
    skew[7] = rng.standard_normal(257)
    skew[40:60] = 0
    cases["skewed_300x257"] = skew
    cases = {name: (a, None) for name, a in cases.items()}
    # CSR rows 1 and 3 are hubs between empty rows 0, 2; the BCSR part
    # starts at row 4 with a hub block-row (the split group right after the
    # boundary) and has another at row 36, between empty block-rows at Br
    # 4, 8 and 16.
    wide = np.zeros((68, HUB_K))
    for r in (1, 3, 4, 36):
        wide[r] = rng.standard_normal(HUB_K)
    wide[10, 5] = 0.5
    cases["hub_50_units"] = (wide, 4)
    return cases


def phase_kernels() -> dict:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import (csr_from_dense, default_br,
                                  loops_from_csr)
    from repro_torch.core.formats import DevicePanels
    from repro_torch.kernels import bcsr_spmm, csr_spmm, spmm_sdd

    rng = np.random.default_rng(0)
    cases = _adversarial(rng)
    worst = {k: 0.0 for k in KERNELS}
    ms = {}
    ncheck = 0
    most_units = {"csr_panels_spmm": 0, "bcsr_panels_spmm": 0}
    dev = torch.device(DEVICE)
    for dname in ("float32", "float64", "bfloat16", "float16"):
        dt = getattr(torch, dname)
        tol = TOL[dname]
        for cname, (a, fixed_rb) in cases.items():
            for g in (1, 8):
                for br in sorted({4, default_br(dt)}):
                    r_b = ((a.shape[0] // 2) // br * br if fixed_rb is None
                           else fixed_rb)
                    fmt = loops_from_csr(csr_from_dense(a.astype(np.float64)),
                                         r_b, br, panel_g=g)
                    cp, bp = (dataclasses.replace(
                        p, vals=p.vals.to(dt)) for p in (
                        DevicePanels.upload(fmt.csr_panels, dev),
                        DevicePanels.upload(fmt.bcsr_panels, dev)))
                    # The uploaded tables (each module's UNIT_PANELS) and
                    # tables that force splits at U = 1, 2, 3 panels.
                    tables = {name: [p.units] + [
                        csr_spmm.unit_table_of(p.ptr, u)
                        for u in SPLIT_UNIT_PANELS]
                        for name, p in (("csr_panels_spmm", cp),
                                        ("bcsr_panels_spmm", bp))}
                    for name, ts in tables.items():
                        most_units[name] = max(most_units[name], max(
                            int(t.units[:, 0].bincount().max())
                            if t.nunits else 0 for t in ts))
                    for batch in (None, 3, 11):
                        for n in (32, 40, 600):
                            shape = ((a.shape[1], n) if batch is None
                                     else (batch, a.shape[1], n))
                            b = torch.as_tensor(
                                rng.standard_normal(shape)).to(dev, dt)
                            for name, fn, plain, kw, p in (
                                    ("csr_panels_spmm",
                                     csr_spmm.csr_panels_spmm,
                                     csr_spmm.csr_panels_spmm_plain,
                                     {"nrows": r_b}, cp),
                                    ("bcsr_panels_spmm",
                                     bcsr_spmm.bcsr_panels_spmm,
                                     bcsr_spmm.bcsr_panels_spmm_plain,
                                     {"nblocks": fmt.bcsr_part.nblocks}, bp)):
                                want = plain(p.rows, p.cols, p.vals, p.mask,
                                             b, **kw)
                                for t in tables[name]:
                                    got = fn(p.rows, p.cols, p.vals, p.mask,
                                             b, units=t, **kw)
                                    torch.cuda.synchronize()
                                    check(got.shape == want.shape
                                          and got.dtype == want.dtype,
                                          f"{name} {cname}: {got.shape} "
                                          f"{got.dtype} vs {want.shape} "
                                          f"{want.dtype}")
                                    err, scale = max_err(got, want)
                                    check(err <= tol * scale,
                                          f"{name} {dname} {cname} g={g} "
                                          f"br={br} batch={batch} n={n} "
                                          f"U={t.unit_panels}: err "
                                          f"{err:.3g} > {tol:g} * "
                                          f"{scale:.3g}")
                                    worst[name] = max(worst[name],
                                                      err / scale)
                                    ncheck += 1
                            ncheck += _sdd_checks(fmt, cp, bp, b, dt, tol,
                                                  worst, rng)
                    # The fused buffer: B1 fills [0, r_b), B2 the rows from
                    # r_b on, and out_dtype = the storage dtype; the plain
                    # pair first, then the kernels at every unit table.
                    b = torch.as_tensor(rng.standard_normal(
                        (3, a.shape[1], 40))).to(dev, dt)
                    rows = r_b + fmt.bcsr_part.nblocks * br
                    want = torch.full((3, rows, 40), float("nan"), dtype=dt,
                                      device=dev)
                    csr_spmm.csr_panels_spmm_plain(
                        cp.rows, cp.cols, cp.vals, cp.mask, b, nrows=r_b,
                        out_dtype=dt, out=want)
                    bcsr_spmm.bcsr_panels_spmm_plain(
                        bp.rows, bp.cols, bp.vals, bp.mask, b,
                        nblocks=fmt.bcsr_part.nblocks, row_offset=r_b,
                        out_dtype=dt, out=want)
                    for ct, bt in zip(tables["csr_panels_spmm"],
                                      tables["bcsr_panels_spmm"]):
                        y = torch.full((3, rows, 40), float("nan"),
                                       dtype=dt, device=dev)
                        csr_spmm.csr_panels_spmm(
                            cp.rows, cp.cols, cp.vals, cp.mask, b,
                            nrows=r_b, units=ct, out_dtype=dt, out=y)
                        bcsr_spmm.bcsr_panels_spmm(
                            bp.rows, bp.cols, bp.vals, bp.mask, b,
                            nblocks=fmt.bcsr_part.nblocks, units=bt,
                            row_offset=r_b, out_dtype=dt, out=y)
                        torch.cuda.synchronize()
                        check(not y.isnan().any(),
                              f"fused buffer {dname} {cname} "
                              f"U={ct.unit_panels}: a row was not written")
                        err, scale = max_err(y, want)
                        check(err <= tol * scale,
                              f"fused buffer {dname} {cname} g={g} br={br} "
                              f"U={ct.unit_panels}: err {err:.3g}")
                        ncheck += 1
    check(min(most_units.values()) >= 50, f"the hub case spans at most "
          f"{most_units} units in one group (want >= 50 in each kernel)")
    # One timing at a mid size per kernel (the main-path times are phase 3).
    a = cases["skewed_300x257"][0].astype(np.float32)
    fmt = validated(loops_from_csr(csr_from_dense(a), 152, 8, panel_g=8),
                    "kernels skewed_300x257")
    cp = DevicePanels.upload(fmt.csr_panels, dev)
    bp = DevicePanels.upload(fmt.bcsr_panels, dev)
    b = torch.as_tensor(rng.standard_normal((257, 32)).astype(
        np.float32)).to(dev)
    ms["csr_panels_spmm"] = time_ms(lambda: csr_spmm.csr_panels_spmm(
        cp.rows, cp.cols, cp.vals, cp.mask, b, nrows=152, units=cp.units))
    ms["bcsr_panels_spmm"] = time_ms(lambda: bcsr_spmm.bcsr_panels_spmm(
        bp.rows, bp.cols, bp.vals, bp.mask, b, nblocks=fmt.bcsr_part.nblocks,
        units=bp.units))
    dy = torch.as_tensor(rng.standard_normal((300, 32)).astype(
        np.float32)).to(dev)
    ms["csr_sdd_panels"] = time_ms(lambda: spmm_sdd.csr_sdd_panels(
        cp.rows, cp.cols, cp.mask, dy, b, blocks=cp.sdd_blocks))
    ms["bcsr_sdd_panels"] = time_ms(lambda: spmm_sdd.bcsr_sdd_panels(
        bp.rows, bp.cols, bp.mask, dy, b, br=8, row_offset=152, nrows=148,
        units=bp.units))
    worst_row = {k: 0.0 for k in FLASH_ROW_TOL}
    ncheck += _flash_checks(worst, worst_row)
    n_contract, contract = _flash_contract(worst, worst_row)
    ncheck += n_contract
    ncheck += _wkv6_checks(worst)
    ncheck += _wkv6_bwd_checks(worst)
    ops = _op_checks(fmt, cp, bp, b, dy)
    rec = {"phase": "kernels_vs_plain", "checks": ncheck,
           "most_units_in_one_group": most_units,
           "flash_attention_max_row_err": worst_row,
           "flash_attention_contract": contract, "operators": ops,
           "kernels": [{"name": k, "launches_in_checks":
                        _kernel_fns()[k].launches,
                        "max_rel_err": worst[k],
                        "ms_300x257_fp32_n32": ms.get(k)}
                       for k in worst]}
    phase(rec)
    return rec


def _op_checks(fmt, cp, bp, b, dy) -> dict:
    """B1-B5, wkv6 and wkv6_bwd through their operators
    (``kernels/_ops.py``), at the timing case (fp32, N 32), B5 at (2, 256, 8
    heads, 2 kv, hd 64) causal in bf16 and wkv6 / wkv6_bwd at (2, 37, 40
    heads, 64) from a state (the backward on the forward's snapshots, with
    a final-state cotangent): a wrapper call is one ``torch.ops.repro_torch``
    call and one launch, and two calls are bitwise equal.  (Fake calls,
    which launch nothing, and the operators' flop counts are phase 19's
    and ``tests/test_torch_gpu.py``'s.)"""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels import (bcsr_spmm, csr_spmm, flash_attention,
                                     spmm_sdd, wkv6)

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.name())
            return func(*args, **(kwargs or {}))

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    q = torch.randn((2, 256, 8, 64), generator=gen, device=DEVICE).to(
        torch.bfloat16)
    k, v = (torch.randn((2, 256, 2, 64), generator=gen, device=DEVICE).to(
        torch.bfloat16) for _ in range(2))
    nb = fmt.bcsr_part.nblocks
    calls = {
        "csr_panels_spmm": lambda: csr_spmm.csr_panels_spmm(
            cp.rows, cp.cols, cp.vals, cp.mask, b, nrows=fmt.r_boundary,
            units=cp.units, live=cp.live),
        "bcsr_panels_spmm": lambda: bcsr_spmm.bcsr_panels_spmm(
            bp.rows, bp.cols, bp.vals, bp.mask, b, nblocks=nb,
            units=bp.units, live=bp.live),
        "csr_sdd_panels": lambda: spmm_sdd.csr_sdd_panels(
            cp.rows, cp.cols, cp.mask, dy, b, blocks=cp.sdd_blocks,
            live=cp.live),
        "bcsr_sdd_panels": lambda: spmm_sdd.bcsr_sdd_panels(
            bp.rows, bp.cols, bp.mask, dy, b, br=8,
            row_offset=fmt.r_boundary, nrows=fmt.nrows - fmt.r_boundary,
            units=bp.units, live=bp.live),
        "flash_attention": lambda: flash_attention.flash_attention(
            q, k, v, causal=True),
        "wkv6": lambda: wkv6.wkv6(*rkvw)[0],
        "wkv6_bwd": lambda: torch.cat([g.reshape(-1) for g in wkv6.wkv6_bwd(
            *rkvw[:5], wdy, snap, rkvw[5])]),
    }
    rkvw = _wkv6_inputs(2, 37, 40, True, seed=8)
    wdy = torch.randn(rkvw[0].shape, generator=gen, device=DEVICE)
    snap = wkv6.wkv6(*rkvw, snapshots=True)[2]
    fns = _kernel_fns()
    rec = {}
    for name, call in calls.items():
        before = fns[name].launches
        with Ops() as mode:
            first = call()
        second = call()
        torch.cuda.synchronize()
        check(mode.names.count(f"repro_torch::{name}") == 1
              and fns[name].launches == before + 2,
              f"{name}: one call dispatched {mode.names} and the two "
              f"launched {fns[name].launches - before} times")
        check(torch.equal(first, second), f"{name}: two calls differ")
        rec[name] = f"repro_torch::{name}"
    return rec


def _flash_checks(worst, worst_row) -> int:
    """B5 against its plain version on the same card tensors, every shape
    of ``FLASH_SHAPES``, causal and not, fp32 / bf16 / f16: at
    ``FLASH_TOL`` of max(1, max |plain|) and at ``FLASH_ROW_TOL`` of each
    row (the worst by dtype into ``worst_row``)."""
    import torch
    from repro_torch.kernels import flash_attention as b5
    checks = 0
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    for bsz, seq, heads, kv, hd in FLASH_SHAPES:
        for dname, tol in FLASH_TOL.items():
            dt = getattr(torch, dname)
            q = torch.randn((bsz, seq, heads, hd), generator=gen,
                            device=DEVICE).to(dt)
            k = torch.randn((bsz, seq, kv, hd), generator=gen,
                            device=DEVICE).to(dt)
            v = torch.randn((bsz, seq, kv, hd), generator=gen,
                            device=DEVICE).to(dt)
            for causal in (True, False):
                got = b5.flash_attention(q, k, v, causal=causal)
                want = b5.flash_attention_plain(q, k, v, causal=causal)
                torch.cuda.synchronize()
                check(got.shape == want.shape and got.dtype == dt,
                      f"flash_attention: {got.shape} {got.dtype}")
                err, scale = max_err(got, want)
                check(err <= tol * scale, f"flash_attention {dname} "
                      f"{(bsz, seq, heads, kv, hd)} causal={causal}: err "
                      f"{err:.3g} > {tol:g} * {scale:.3g}")
                rerr = row_err(got, want)
                check(rerr <= FLASH_ROW_TOL[dname], f"flash_attention "
                      f"{dname} {(bsz, seq, heads, kv, hd)} causal={causal}"
                      f": row err {rerr:.3g} > {FLASH_ROW_TOL[dname]:g}")
                worst["flash_attention"] = max(worst["flash_attention"],
                                               err / scale)
                worst_row[dname] = max(worst_row[dname], rerr)
                checks += 1
            del q, k, v, got, want
    return checks


def _wkv6_inputs(bsz: int, seq: int, heads: int, nonzero_s0: bool, *,
                 seed: int = 9):
    """wkv6's inputs on the card at head size 64: r, k, v ~ N(0, 1), the
    model's decay w = exp(-exp(N(-2, 1))) (w0 = -2), u ~ N(0, 0.1²), s0 ~
    N(0, 1) or zeros."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)
    r, k, v = (rnd(bsz, seq, heads, 64) for _ in range(3))
    w = torch.exp(-torch.exp(rnd(bsz, seq, heads, 64) - 2.0))
    u = 0.1 * rnd(heads, 64)
    s0 = (rnd(bsz, heads, 64, 64) if nonzero_s0
          else torch.zeros((bsz, heads, 64, 64), device=DEVICE))
    return r, k, v, w, u, s0


def _wkv6_err(got, want, mag) -> float:
    """The largest |got - want| over the magnitude recurrence's value."""
    return float(((got - want).abs() / mag.clamp_min(1e-30)).max())


def _wkv6_checks(worst) -> int:
    """wkv6 against its plain loop at ``WKV6_SHAPES``: y and the final
    state, each element within ``WKV6_TOL`` of the same recurrence run on
    magnitudes (|r|, |k|, |v|, w, |u|, |s0|); the state written in place
    into ``s0`` itself; the zero-state launch (``s0=None``) equal to one
    from a zero buffer."""
    import torch
    from repro_torch.kernels import wkv6
    checks = 0
    for bsz, seq, heads, nonzero in WKV6_SHAPES:
        r, k, v, w, u, s0 = _wkv6_inputs(bsz, seq, heads, nonzero)
        want_y, want_s = wkv6.wkv6_plain(r, k, v, w, u, s0)
        mag_y, mag_s = wkv6.wkv6_plain(r.abs(), k.abs(), v.abs(), w,
                                       u.abs(), s0.abs())
        state = s0.clone()
        y, out = wkv6.wkv6(r, k, v, w, u, state, state=state)
        y0, out0 = wkv6.wkv6(r, k, v, w, u, s0 if nonzero else None)
        torch.cuda.synchronize()
        err = max(_wkv6_err(y, want_y, mag_y), _wkv6_err(out, want_s,
                                                          mag_s))
        check(out is state and err <= WKV6_TOL and torch.equal(y, y0)
              and torch.equal(out, out0),
              f"wkv6 {(bsz, seq, heads, 64)} s0={nonzero}: err {err:.3g} "
              f"of the magnitude recurrence (limit {WKV6_TOL:g}), repeat "
              f"equal {torch.equal(y, y0) and torch.equal(out, out0)}")
        worst["wkv6"] = max(worst["wkv6"], err)
        checks += 1
        del r, k, v, w, u, s0, want_y, want_s, mag_y, mag_s, y, y0
    return checks


def _wkv6_bwd_case(bsz: int, seq: int, heads: int, nonzero: bool, *,
                   seed: int):
    """wkv6_bwd's inputs on the card: :func:`_wkv6_inputs`, dy ~ N(0, 1),
    dS_T ~ N(0, 1) when ``nonzero`` (else None), and the forward kernel's
    snapshots; returns ``(args, start, dsT)``, ``args`` the wrapper's
    positional arguments."""
    import torch
    from repro_torch.kernels import wkv6
    r, k, v, w, u, s0 = _wkv6_inputs(bsz, seq, heads, nonzero, seed=seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    dy = torch.randn(r.shape, generator=gen, device=DEVICE)
    dsT = (torch.randn(s0.shape, generator=gen, device=DEVICE) if nonzero
           else None)
    start = s0 if nonzero else None
    snap = wkv6.wkv6(r, k, v, w, u, start, snapshots=True)[2]
    return (r, k, v, w, u, dy, snap, dsT), start, dsT


def _wkv6_bwd_checks(worst) -> int:
    """wkv6_bwd against ``wkv6_bwd_plain`` at ``WKV6_BWD_SHAPES``: every
    gradient element within ``WKV6_TOL`` of the same derivative run on
    magnitudes (|r|, |k|, |v|, w, |u|, |dy|, |s0|, |dS_T|); two calls
    bitwise equal (no atomics: phase 22's resume leans on it)."""
    import torch
    from repro_torch.kernels import wkv6
    checks = 0
    for bsz, seq, heads, nonzero in WKV6_BWD_SHAPES:
        args, start, dsT = _wkv6_bwd_case(bsz, seq, heads, nonzero,
                                          seed=20 + seq)
        r, k, v, w, u, dy, _, _ = args
        got = wkv6.wkv6_bwd(*args)
        again = wkv6.wkv6_bwd(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = wkv6.wkv6_bwd_plain(r, k, v, w, u, dy, start, dsT)
        mag = wkv6.wkv6_bwd_plain(
            r.abs(), k.abs(), v.abs(), w, u.abs(), dy.abs(),
            None if start is None else start.abs(),
            None if dsT is None else dsT.abs())
        err = max(_wkv6_err(g, x, m) for g, x, m in zip(got, want, mag))
        check(same and err <= WKV6_TOL, f"wkv6_bwd {(bsz, seq, heads, 64)} "
              f"s0={nonzero}: err {err:.3g} of the magnitude derivative "
              f"(limit {WKV6_TOL:g}), repeat equal {same}")
        worst["wkv6_bwd"] = max(worst["wkv6_bwd"], err)
        checks += 1
        del args, got, want, mag
    return checks


def _sdpa_contract(q, k, v, causal: bool, window: int):
    """``scaled_dot_product_attention`` computing B5's function on the
    same tensors, or None: ``is_causal`` only where Sq == Sk and no window
    (its causal mask is top-left aligned, the reference's bottom-right);
    an explicit boolean mask for a window or a prefix offset; none where a
    row may see no key (SDPA gives NaN there)."""
    import torch
    import torch.nn.functional as F
    seq, seq_k = q.shape[1], k.shape[1]
    off = seq_k - seq
    if causal and off < 0:
        return None, None
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if not window and (not causal or off == 0):
        return (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True),
            f"scaled_dot_product_attention(is_causal={causal}, "
            "enable_gqa=True)")
    qpos = torch.arange(seq, device=q.device)[:, None]
    kpos = torch.arange(seq_k, device=q.device)[None, :]
    mask = torch.ones((seq, seq_k), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos + off
    if window:
        mask &= kpos > qpos + off - window
    return (lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True),
        "scaled_dot_product_attention(attn_mask=the reference's boolean "
        "mask, enable_gqa=True)")


def _flash_contract(worst, worst_row) -> tuple:
    """B5 at ``FLASH_CONTRACT``: against the plain version in bf16 and
    fp32 (``FLASH_TOL`` of max(1, max |plain|), ``FLASH_ROW_TOL`` a row),
    its lse within ``LSE_TOL``; then in bf16 its time, SDPA's where SDPA
    computes the same function (:func:`_sdpa_contract`) and the bound from
    the kept pairs.  Returns ``(checks, records)``."""
    import torch
    from repro_torch.kernels import flash_attention as b5
    checks, recs = 0, []
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    for name, bsz, seq, seq_k, heads, kv, hd, causal, window in \
            FLASH_CONTRACT:
        for dname, tol in FLASH_TOL.items():
            if dname == "float16":
                continue
            dt = getattr(torch, dname)
            q = torch.randn((bsz, seq, heads, hd), generator=gen,
                            device=DEVICE).to(dt)
            k, v = (torch.randn((bsz, seq_k, kv, hd), generator=gen,
                                device=DEVICE).to(dt) for _ in range(2))
            kw = {"causal": causal, "window": window}
            got, lse = b5.flash_attention(q, k, v, return_lse=True, **kw)
            want, lse_p = b5.flash_attention_plain(q, k, v, return_lse=True,
                                                   **kw)
            torch.cuda.synchronize()
            err, scale = max_err(got, want)
            rerr = row_err(got, want)
            lerr = float(((lse - lse_p).abs()
                          / lse_p.abs().clamp_min(1.0)).max())
            check(got.shape == want.shape and err <= tol * scale
                  and rerr <= FLASH_ROW_TOL[dname] and lerr <= LSE_TOL,
                  f"flash_attention {name} {dname}: err {err:.3g} (scale "
                  f"{scale:.3g}), row err {rerr:.3g}, lse err {lerr:.3g}")
            worst["flash_attention"] = max(worst["flash_attention"],
                                           err / scale)
            worst_row[dname] = max(worst_row[dname], rerr)
            checks += 1
            if dname != "bfloat16" or name == "dead_rows":
                continue
            sdpa, lib_name = _sdpa_contract(q, k, v, causal, window)
            rec = {"case": name, "dtype": dname, "shape": [bsz, seq, heads,
                                                          hd],
                   "seq_k": seq_k, "kv_heads": kv, "causal": causal,
                   "window": window, "max_err_rel": err / scale,
                   "max_row_err": rerr,
                   "ms": time_ms(lambda: b5.flash_attention(q, k, v, **kw)),
                   "library": lib_name, "library_ms": None,
                   **flash_bound(q, k, causal=causal, window=window)}
            if sdpa is not None:
                lib_out = sdpa().transpose(1, 2)
                rec["library_ms"] = time_ms(sdpa)
                rec["library_max_row_err"] = row_err(lib_out, want)
                del lib_out
            rec.update(rate(rec))
            recs.append(rec)
        del q, k, v, got, want, lse, lse_p
    return checks, recs


def _sdd_checks(fmt, cp, bp, b, dt, tol, worst, rng) -> int:
    """B3 and B4 against their plain versions for one operand ``b``: dY in
    b's dtype and, for half b, in fp32 (the training backward's pair); B4
    on the whole cotangent with the part's row offset, and on the
    zero-padded BCSR rows, which must give the same numbers."""
    import torch
    from repro_torch.kernels import spmm_sdd
    m = fmt.nrows
    r_b, br, nblocks = fmt.r_boundary, fmt.bcsr_part.br, fmt.bcsr_part.nblocks
    n = b.shape[-1]
    checks = 0
    for dy_dt in ((dt,) if dt.itemsize >= 4 else (dt, torch.float32)):
        dy = torch.as_tensor(rng.standard_normal(
            b.shape[:-2] + (m, n))).to(b.device, dy_dt)
        dy_pad = torch.zeros(b.shape[:-2] + (nblocks * br, n), dtype=dy_dt,
                             device=b.device)
        dy_pad[..., :m - r_b, :] = dy[..., r_b:, :]
        outs = []
        for name, fn, plain, p, d, kw in (
                ("csr_sdd_panels", spmm_sdd.csr_sdd_panels,
                 spmm_sdd.csr_sdd_panels_plain, cp, dy, {}),
                ("bcsr_sdd_panels", spmm_sdd.bcsr_sdd_panels,
                 spmm_sdd.bcsr_sdd_panels_plain, bp, dy,
                 {"br": br, "row_offset": r_b, "nrows": m - r_b}),
                ("bcsr_sdd_panels", spmm_sdd.bcsr_sdd_panels,
                 spmm_sdd.bcsr_sdd_panels_plain, bp, dy_pad, {"br": br})):
            got = fn(p.rows, p.cols, p.mask, d, b, **kw)
            want = plain(p.rows, p.cols, p.mask, d, b, **kw)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name}: {got.shape} {got.dtype} vs {want.shape} "
                  f"{want.dtype}")
            err, scale = max_err(got, want)
            check(err <= tol * scale, f"{name} {dt} dy {dy_dt} "
                  f"{tuple(b.shape)} m={m} r_b={r_b} br={br}: err "
                  f"{err:.3g} > {tol:g} * {scale:.3g}")
            worst[name] = max(worst[name], err / scale)
            outs.append(got)
            checks += 1
        check(torch.equal(outs[1], outs[2]), f"bcsr_sdd_panels {dt}: the "
              "row-offset form differs from the zero-padded rows")
    return checks


# ---------------------------------------------------------------------------
# phase 3: the main path at published sizes
# ---------------------------------------------------------------------------

# The kernels of the port's paths: B1 and B2 (product), B3 and B4 (value
# gradient), B5 (the LM's prefill attention).
KERNELS = ("csr_panels_spmm", "bcsr_panels_spmm", "csr_sdd_panels",
           "bcsr_sdd_panels", "flash_attention", "wkv6", "wkv6_bwd")


def _kernel_fns() -> dict:
    from repro_torch.kernels import (bcsr_spmm, csr_spmm, flash_attention,
                                     spmm_sdd, wkv6)
    return {"csr_panels_spmm": csr_spmm.csr_panels_spmm,
            "bcsr_panels_spmm": bcsr_spmm.bcsr_panels_spmm,
            "csr_sdd_panels": spmm_sdd.csr_sdd_panels,
            "bcsr_sdd_panels": spmm_sdd.bcsr_sdd_panels,
            "flash_attention": flash_attention.flash_attention,
            "wkv6": wkv6.wkv6, "wkv6_bwd": wkv6.wkv6_bwd}


def _reset_counts():
    for fn in _kernel_fns().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {k: fn.launches for k, fn in _kernel_fns().items()}


def phase_main(launches: dict) -> list:
    import numpy as np
    import torch
    from repro_torch.core import loops_spmm, plan_and_convert, suite
    from repro_torch.core.formats import csr_slice_rows
    from repro_torch.kernels import bcsr_spmm, csr_spmm

    out = []
    for mid, rows, dtypes in MAIN_MATRICES:
        t0 = time.perf_counter()
        base = suite.table2_like(mid, scale_rows=rows, seed=0,
                                 dtype=np.float32)
        gen_s = time.perf_counter() - t0
        for dname in dtypes:
            dt = getattr(torch, dname)
            csr = base.astype(np.dtype(dname))
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fmt, plan = plan_and_convert(csr, device=DEVICE)
            torch.cuda.synchronize()
            convert_s = time.perf_counter() - t0
            validated(fmt, f"main {mid} {dname}")
            gen = torch.Generator(device=DEVICE).manual_seed(1)
            b = torch.randn((csr.shape[1], MAIN_N), generator=gen,
                            device=DEVICE, dtype=torch.float32).to(dt)

            _reset_counts()
            y = loops_spmm(fmt, b)
            torch.cuda.synchronize()
            counts = _read_counts()
            for k, v in counts.items():
                launches[k] += v
            has = {"csr_panels_spmm": plan.r_boundary > 0,
                   "bcsr_panels_spmm": plan.r_boundary < csr.nrows,
                   "csr_sdd_panels": False, "bcsr_sdd_panels": False,
                   "flash_attention": False, "wkv6": False,
                   "wkv6_bwd": False}
            for k, v in counts.items():
                check(v == int(has[k]), f"{mid} {dname}: {k} launched {v} "
                      f"times in one loops_spmm (expected {int(has[k])})")

            # Two calls give the same bits (fixed summation order).
            again = loops_spmm(fmt, b)
            torch.cuda.synchronize()
            check(torch.equal(y, again), f"{mid} {dname}: two loops_spmm "
                  "calls differ")
            del again
            want = loops_spmm(fmt, b, backend="torch")
            torch.cuda.synchronize()
            check(y.shape == (csr.nrows, MAIN_N) and bool(
                torch.isfinite(y).all()), f"{mid} {dname}: bad output "
                f"{tuple(y.shape)}")
            absprod = loops_spmm(abs_format(fmt), b.abs(), backend="torch")
            err, rel = sum_err(y, want, absprod)
            tol = TOL[dname]
            check(rel <= tol, f"{mid} {dname} loops_spmm vs flat torch: err "
                  f"{err:.3g}, {rel:.3g} of |A||B| > {tol:g}")

            dev = fmt.on(DEVICE)
            r_b, br = fmt.r_boundary, fmt.bcsr_part.br
            nblocks = fmt.bcsr_part.nblocks
            acc_elem = torch.empty((), dtype=y.dtype).element_size()
            buf = torch.empty((1, r_b + nblocks * br, MAIN_N), dtype=y.dtype,
                              device=DEVICE)
            b3 = b[None]
            kernels = {}
            parts = (
                ("csr_panels_spmm", dev.csr, 1,
                 lambda: csr_spmm.csr_panels_spmm(
                     dev.csr.rows, dev.csr.cols, dev.csr.vals, dev.csr.mask,
                     b3, nrows=r_b, units=dev.csr.units, out=buf),
                 lambda vals=dev.csr.vals, b=b3:
                 csr_spmm.csr_panels_spmm_plain(
                     dev.csr.rows, dev.csr.cols, vals, dev.csr.mask, b,
                     nrows=r_b),
                 csr_slice_rows(csr, 0, r_b)),
                ("bcsr_panels_spmm", dev.bcsr, br,
                 lambda: bcsr_spmm.bcsr_panels_spmm(
                     dev.bcsr.rows, dev.bcsr.cols, dev.bcsr.vals,
                     dev.bcsr.mask, b3, nblocks=nblocks,
                     units=dev.bcsr.units, row_offset=r_b, out=buf),
                 lambda vals=dev.bcsr.vals, b=b3:
                 bcsr_spmm.bcsr_panels_spmm_plain(
                     dev.bcsr.rows, dev.bcsr.cols, vals, dev.bcsr.mask, b,
                     nblocks=nblocks),
                 csr_slice_rows(csr, r_b, csr.nrows)))
            for name, panels, pbr, run, plain, part_csr in parts:
                if not has[name]:
                    continue
                run()
                got = buf[:, :r_b] if name.startswith("csr") else \
                    buf[:, r_b:]
                ref_out = plain()
                absprod = plain(vals=panels.vals.abs(), b=b3.abs())
                torch.cuda.synchronize()
                k_err, k_rel = sum_err(got, ref_out, absprod)
                check(k_rel <= tol, f"{mid} {dname} {name} vs plain: err "
                      f"{k_err:.3g}, {k_rel:.3g} of |A||B| > {tol:g}")
                lib, lib_what = library_ms(part_csr, b, dt)
                units = panels.units
                unit_panels = (csr_spmm if name.startswith("csr")
                               else bcsr_spmm).UNIT_PANELS
                check(units.unit_panels == unit_panels
                      and units.max_panels <= unit_panels,
                      f"{mid} {dname} {name}: a unit holds "
                      f"{units.max_panels} panels (U = {unit_panels})")
                kernels[name] = {
                    "ms": time_ms(run), "device_ms": device_ms(run),
                    "plain_ms": time_ms(
                        plain, samples=10, reps=1, warmup=1),
                    "library_ms": lib, "library": lib_what,
                    "max_abs_err": k_err, "max_err_of_absprod": k_rel,
                    "npanels": int(panels.rows.numel()),
                    "groups": panels.ngroups,
                    # the longest walk one warp makes (the tail)
                    "max_panels_per_group": int(
                        (panels.ptr[1:] - panels.ptr[:-1]).max()),
                    "unit_panels": units.unit_panels,
                    "units": units.nunits, "split_groups": units.nsplit,
                    "max_panels_per_unit": units.max_panels,
                    "workspace_bytes": units.nslots * pbr * MAIN_N
                    * acc_elem,
                    **panel_bound(panels, b3, acc_elem, br=pbr,
                                  dtype=dname)}
            lib, lib_what = library_ms(csr, b, dt)
            rec = {"phase": "main", "matrix": mid,
                   "name": suite.TABLE2_STATS[mid].name, "rows": csr.nrows,
                   "nnz": csr.nnz, "dtype": dname, "n": MAIN_N,
                   "generate_s": gen_s, "plan_and_convert_s": convert_s,
                   "r_boundary": plan.r_boundary, "br": br,
                   "panel_g": plan.panel_g, "launches": counts,
                   "loops_spmm_ms": time_ms(lambda: loops_spmm(fmt, b)),
                   "loops_spmm_max_abs_err": err,
                   "loops_spmm_max_err_of_absprod": rel,
                   "library_ms": lib, "library": lib_what,
                   "dense_matmul": "not run: the dense A does not fit",
                   "kernels": kernels,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            if (mid, dname) == B3_MAIN:
                # After the launch counts and the phase's own times: B3 is
                # not on the forward path.
                kernels["csr_sdd_panels"] = _b3_main(fmt, csr, gen, dname)
            phase(rec)
            out.append(rec)
            del fmt, dev, buf, y, want, absprod
            torch.cuda.empty_cache()
    return out


def block_counts(blocks) -> dict:
    """What B3's block table (``kernels/spmm_sdd.py::SddBlockTable``)
    holds: blocks of each kind, the staged blocks' distinct columns (the B
    rows they stage) and dY rows, and the largest of each."""
    staged = blocks.blocks[:blocks.nstaged]   # the staged blocks come first
    return {"blocks": blocks.nblocks, "staged_blocks": blocks.nstaged,
            "direct_blocks": blocks.ndirect,
            "staged_cols": int(blocks.cols.numel()),
            "staged_dy_rows": int(staged[:, 6].sum()),
            "staged_outputs": int(blocks.outs.numel()),
            "max_cols": blocks.max_cols, "max_rows": blocks.max_rows}


def _b3_main(fmt, csr, gen, dname) -> dict:
    """B3 alone on the main path's CSR part (at in-2004's size, its hub
    rows), N = ``MAIN_N``, dY and B from the phase's generator: against its
    plain version at ``TOL`` of |dY|·|B| and a second call (bitwise equal),
    its time, device time, bound and ``torch.sparse.sampled_addmm``'s time,
    and the part's block table."""
    import torch
    from repro_torch.core.formats import csr_slice_rows
    from repro_torch.kernels import spmm_sdd
    dt = getattr(torch, dname)
    p = fmt.on(DEVICE).csr
    r_b = fmt.r_boundary
    t0 = time.perf_counter()
    blocks = p.sdd_blocks
    table_s = time.perf_counter() - t0
    b3 = torch.randn((1, csr.shape[1], MAIN_N), generator=gen, device=DEVICE,
                     dtype=torch.float32).to(dt)
    dy3 = torch.randn((1, csr.nrows, MAIN_N), generator=gen, device=DEVICE,
                      dtype=torch.float32).to(dt)

    def run():
        return spmm_sdd.csr_sdd_panels(p.rows, p.cols, p.mask, dy3, b3,
                                       blocks=blocks)

    def plain(d=dy3, b=b3):
        return spmm_sdd.csr_sdd_panels_plain(p.rows, p.cols, p.mask, d, b)
    got, again = run(), run()
    want = plain()
    absprod = plain(dy3.abs(), b3.abs())
    torch.cuda.synchronize()
    err, rel = sum_err(got, want, absprod)
    check(rel <= TOL[dname], f"B3 on the {dname} main-path CSR part vs "
          f"plain: err {err:.3g}, {rel:.3g} of |dY||B| > {TOL[dname]:g}")
    check(torch.equal(got, again), f"B3 on the {dname} main-path CSR part: "
          "two calls differ")
    lib, lib_what = library_sdd_ms(csr_slice_rows(csr, 0, r_b), dy3[0, :r_b],
                                   b3[0].t(), dt)
    rec = {"ms": time_ms(run), "device_ms": device_ms(run),
           "plain_ms": time_ms(plain, samples=3, reps=1, warmup=1),
           "library_ms": lib, "library": lib_what,
           "max_abs_err": err, "max_err_of_absprod": rel,
           "bitwise_repeatable": True, "npanels": int(p.rows.numel()),
           "stored_values": int(p.mask.sum()), "rows": r_b,
           "table_s": table_s, **block_counts(blocks),
           **sdd_bound(p, dy3, b3, got, br=1, dy_rows=r_b, dtype=dname)}
    rec.update(rate(rec))
    del got, again, want, absprod, b3, dy3
    return rec


# ---------------------------------------------------------------------------
# phase 4: the autotuner (tune/) on the card
# ---------------------------------------------------------------------------

def near_rows(rows: int) -> int:
    """``rows`` moved to 0.05 past its nearest quantisation edge in log2
    (the plan cache's 0.5-wide bins sit at x.25 and x.75)."""
    import math
    x = math.log2(rows)
    edges = (math.floor(x - 0.25) + 0.25, math.floor(x - 0.25) + 0.75,
             math.floor(x - 0.25) + 1.25)
    edge = min(edges, key=lambda e: abs(e - x))
    return int(round(2 ** (edge + (0.05 if edge > x else -0.05))))


def _dispatches(obs) -> dict:
    """The capture's ``engine.dispatch`` counts of kernel launches
    (``backend=cuda``, ``impl=panels``) by part."""
    out = {"csr": 0.0, "bcsr": 0.0}
    for kind, inst in obs.metrics.instruments():
        if (kind == "counter" and inst.name == "engine.dispatch"
                and inst.labels.get("backend") == "cuda"
                and inst.labels.get("impl") == "panels"
                and inst.labels.get("op") == "spmm"):
            out[inst.labels["part"]] += inst.value
    return out


def phase_tune(launches: dict, out_dir, work_dir) -> list:
    """``autotune`` at phase main's m6 and m4, fp32, N = MAIN_N: a miss
    that searches (every survivor measured on the card, none failed), an
    exact hit with no measurement, a near hit (the same generator across a
    quantisation edge of the row count) reusing the plan and promoted to
    its own key; the tuned ``loops_spmm`` against the flat path and a
    second call, timed beside the default plan's; at m6 dB through
    ``fmt.transposed(tuner=...)`` against the flat path's autograd, a
    ``TraceRecorder`` on the search and a second search ranked by replay
    from its records.  An ``Obs`` capture spans the phase: its dispatch
    counts equal the phase's B1/B2 launches, its ``tune.cache.*`` gauges
    the cache's stats; its JSONL and Chrome trace are written (to
    ``out_dir``, else ``work_dir``) and read back.  The plan cache lives in
    ``work_dir``."""
    import importlib
    import os

    from repro_torch.obs import Obs, load_obs, set_active
    from repro_torch.tune import PlanCache, SearchBudget
    search_mod = importlib.import_module("repro_torch.tune.search")
    api_mod = importlib.import_module("repro_torch.tune.api")

    os.environ["REPRO_TUNE_CACHE"] = str(pathlib.Path(work_dir) / "tune")
    cache = PlanCache()
    obs = Obs(source="chip_smoke_tune")
    obs.watch_cache(cache, name="tune")
    measured = []                  # (plan, gflops) of every measurement
    real_measure = search_mod.measure_plan_gflops

    def counting_measure(csr, plan, b, **kw):
        fmt, g = real_measure(csr, plan, b, **kw)
        measured.append((plan, g))
        return fmt, g
    real_search = api_mod.search
    prev_obs = set_active(obs)
    search_mod.measure_plan_gflops = counting_measure
    budget = SearchBudget(top_k=TUNE_TOP_K)
    recs = []
    _reset_counts()
    try:
        with obs.attach_engine():
            for mid, rows, _ in MAIN_MATRICES:
                recs.append(_tune_matrix(mid, rows, cache, budget, measured,
                                         api_mod, real_search))
    finally:
        search_mod.measure_plan_gflops = real_measure
        api_mod.search = real_search
        set_active(prev_obs)
    counts = _read_counts()
    for k, v in counts.items():
        launches[k] += v
        if k in ("csr_panels_spmm", "bcsr_panels_spmm"):
            check(v > 0, f"tune: {k} never launched")
        else:
            check(v == 0, f"tune: {k} launched {v} times off its path")
    disp = _dispatches(obs)
    check(disp["csr"] == counts["csr_panels_spmm"]
          and disp["bcsr"] == counts["bcsr_panels_spmm"],
          f"tune: engine.dispatch {disp} against launches {counts}")
    check(not any(inst.name == "tune.search.trial_failed"
                  for _, inst in obs.metrics.instruments()),
          "tune: tune.search.trial_failed is not 0")
    st = cache.stats
    gauges = {r["metric"]: r["value"] for r in obs.records()
              if r["kind"] == "gauge" and r["labels"].get("cache") == "tune"}
    check(gauges["tune.cache.hits"] == st.hits
          and gauges["tune.cache.near_hits"] == st.near_hits
          and gauges["tune.cache.misses"] == st.misses
          and gauges["tune.cache.hit_rate"] == st.hit_rate,
          f"tune: gauges {gauges} against stats {st}")
    jsonl, chrome = obs.save(out_dir or work_dir, stem="chip_smoke_tune")
    back = load_obs(jsonl)
    trace = json.loads(pathlib.Path(chrome).read_text())
    check(back[0]["kind"] == "meta" and len(back) == len(obs.records())
          and trace["traceEvents"], "tune: the capture did not read back")
    rec = {"phase": "tune", "cache_stats": {"hits": st.hits, "near_hits": st.near_hits,
                           "misses": st.misses, "hit_rate": st.hit_rate},
           "engine_dispatch": disp, "launches": counts,
           "obs_records": len(back), "obs_jsonl": str(jsonl),
           "matrices": recs}
    phase(rec)
    return recs


def _tune_matrix(mid, rows, cache, budget, measured, api_mod,
                 real_search) -> dict:
    """One matrix of phase ``tune`` (see :func:`phase_tune`): ``measured``
    collects every measurement, ``api_mod.search`` is swapped for
    ``real_search`` with a recorder at m6."""
    import cProfile
    import functools
    import importlib

    import numpy as np
    import torch
    from repro_torch.core import loops_spmm, plan_and_convert, plan_for, suite
    from repro_torch.perf import TraceRecorder
    from repro_torch.tune import (autotune, cache_key, feature_distance,
                                  fingerprint)
    search_mod = importlib.import_module("repro_torch.tune.search")

    def key_of(fp):
        return cache_key(fp, n_cols=MAIN_N, dtype=np.float32, backend="cuda")

    t0 = time.perf_counter()
    csr = suite.table2_like(mid, scale_rows=rows, seed=0, dtype=np.float32)
    gen_s = time.perf_counter() - t0
    rec = {"matrix": mid, "rows": rows, "nnz": csr.nnz, "generate_s": gen_s}

    # miss: the search, with a recorder at m6
    recorder = TraceRecorder(source=f"chip_smoke_tune_{mid}") \
        if mid == "m6" else None
    if recorder is not None:
        api_mod.search = functools.partial(real_search, recorder=recorder)
    n0, st0 = len(measured), lookup_counts(cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fmt, plan = autotune(csr, n_cols=MAIN_N, cache=cache, budget=budget,
                         device=DEVICE)
    torch.cuda.synchronize()
    rec["search_s"] = time.perf_counter() - t0
    api_mod.search = real_search
    trials = measured[n0:]
    fp = fingerprint(csr)
    stored = cache.peek(key_of(fp))
    check(lookup_counts(cache)["misses"] == st0["misses"] + 1,
          f"tune {mid}: the first autotune was not a miss")
    # The survivors, then the model's plan (plan_for's) unless a survivor
    # converts the same way (the tuner's divergence on the card).
    model_plan = plan_for(csr)
    model_extra = int(not any(search_mod._conversion(p)
                              == search_mod._conversion(model_plan)
                              for p, _ in trials[:TUNE_TOP_K]))
    check(len(trials) == TUNE_TOP_K + model_extra
          and stored["trials"] == len(trials)
          and (not model_extra or trials[-1][0] == model_plan),
          f"tune {mid}: {len(trials)} trials for {TUNE_TOP_K} survivors "
          f"and {model_extra} model plan")
    check(all(g > 0 for _, g in trials), f"tune {mid}: a trial measured "
          "no throughput")
    best = max(trials, key=lambda t: t[1])
    check(best[0] == plan and stored["gflops"] == best[1],
          f"tune {mid}: the winner is not the best measured trial")
    rec.update({"trials": [{"plan": plan_dict(p), "gflops": g}
                           for p, g in trials],
                "model_plan_measured": bool(model_extra),
                "winner": plan_dict(plan), "winner_gflops": best[1]})

    # exact hit: no measurement
    n0, st0 = len(measured), lookup_counts(cache)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fmt2, plan2 = autotune(csr, n_cols=MAIN_N, cache=cache, budget=budget,
                           device=DEVICE)
    prof.disable()
    rec["hit_s"] = time.perf_counter() - t0
    rec["hit_profile"] = host_profile(prof)
    check(len(measured) == n0 and plan2 == plan
          and lookup_counts(cache)["hits"] == st0["hits"] + 1,
          f"tune {mid}: the repeat autotune was not an exact hit without "
          "measurement")
    rec["hit_measurements"] = len(measured) - n0
    del fmt2

    # near hit: the same generator across a quantisation edge
    rows_near = near_rows(rows)
    csr_near = suite.table2_like(mid, scale_rows=rows_near, seed=0,
                                 dtype=np.float32)
    fp_near = fingerprint(csr_near)
    dist = feature_distance(fp.features(), fp_near.features())
    n0, st0 = len(measured), lookup_counts(cache)
    t0 = time.perf_counter()
    fmt_n, plan_n = autotune(csr_near, n_cols=MAIN_N, cache=cache,
                             budget=budget, device=DEVICE)
    rec["near_s"] = time.perf_counter() - t0
    promoted = cache.peek(key_of(fp_near))
    check(key_of(fp_near) != key_of(fp) and len(measured) == n0
          and lookup_counts(cache)["near_hits"] == st0["near_hits"] + 1
          and promoted is not None and promoted["plan"] == stored["plan"]
          and (plan_n.br, plan_n.panel_g, plan_n.macro_m, plan_n.t_vpu)
          == (plan.br, plan.panel_g, plan.macro_m, plan.t_vpu),
          f"tune {mid}: the matrix of {rows_near} rows (distance "
          f"{dist:.3f}) was not a promoted near hit")
    rec.update({"near_rows": rows_near, "near_distance": dist,
                "near_plan": plan_dict(plan_n)})
    del fmt_n, csr_near

    # the tuned product against the flat path and a second call, timed
    # beside the default plan's
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    b = torch.randn((csr.shape[1], MAIN_N), generator=gen, device=DEVICE)
    y = loops_spmm(fmt, b, device=DEVICE)
    again = loops_spmm(fmt, b, device=DEVICE)
    want = loops_spmm(fmt, b, device=DEVICE, backend="torch")
    absprod = loops_spmm(abs_format(fmt), b.abs(), device=DEVICE,
                         backend="torch")
    torch.cuda.synchronize()
    err, rel = sum_err(y, want, absprod)
    check(rel <= TOL["float32"], f"tune {mid}: tuned loops_spmm vs flat: "
          f"err {err:.3g}, {rel:.3g} of |A||B|")
    check(torch.equal(y, again), f"tune {mid}: two tuned calls differ")
    del y, again, want, absprod
    t0 = time.perf_counter()
    fmt_d, plan_d = plan_and_convert(csr, device=DEVICE)
    torch.cuda.synchronize()
    default_convert_s = time.perf_counter() - t0
    validated(fmt, f"tune {mid} tuned")
    validated(fmt_d, f"tune {mid} default")
    # The tuned plan against the default, timed in turns; the run-to-run
    # spread is the larger relative range of either plan's readings.
    times = {"tuned": [], "default": []}
    for _ in range(TUNE_TIMING_ROUNDS):
        for name, f in (("tuned", fmt), ("default", fmt_d)):
            times[name].append(time_ms(
                lambda f=f: loops_spmm(f, b, device=DEVICE)))
    tuned_ms = statistics.median(times["tuned"])
    default_ms = statistics.median(times["default"])
    spread = max((max(t) - min(t)) / statistics.median(t)
                 for t in times.values())
    same = search_mod._conversion(plan) == search_mod._conversion(plan_d)
    check(same or tuned_ms <= default_ms * (1 + spread),
          f"tune {mid}: the tuned plan {tuned_ms:.4f} ms loses to the "
          f"default's {default_ms:.4f} ms beyond the spread {spread:.3f}")
    rec.update({"default_convert_s": default_convert_s,
                "default_plan": plan_dict(plan_d),
                "tuned_ms": tuned_ms, "default_ms": default_ms,
                "tuned_ms_runs": times["tuned"],
                "default_ms_runs": times["default"], "spread": spread,
                "tuned_is_default": same,
                "tuned_max_abs_err": err, "tuned_max_err_of_absprod": rel,
                "bitwise_repeatable": True})
    del fmt_d

    if mid == "m6":
        rec.update(_tune_m6_extras(csr, fmt, b, cache, recorder, measured,
                                   len(trials)))
    del fmt, b
    torch.cuda.empty_cache()
    return rec


def _tune_m6_extras(csr, fmt, b, cache, recorder, measured,
                    n_trials) -> dict:
    """Phase tune at m6: the recorder's records, a search ranked by replay
    from them, and dB through the tuned transposed format."""
    import importlib

    import torch
    from repro_torch.core import loops_spmm
    from repro_torch.perf import TraceDB, replay
    from repro_torch.tune import SearchBudget, Tuner
    search_mod = importlib.import_module("repro_torch.tune.search")

    out = {}
    trial_recs = [r for r in recorder.records if r["kind"] == "search_trial"]
    check(len(trial_recs) == n_trials, f"tune m6: the recorder holds "
          f"{len(trial_recs)} search_trial records for {n_trials} trials")
    db = TraceDB(records=list(recorder.records))
    coef = db.step_cost("cuda")
    check(coef is not None, "tune m6: the trace records fit no step cost")
    n0 = len(measured)
    t0 = time.perf_counter()
    res = search_mod.search(csr, n_cols=MAIN_N, trace_db=db,
                            budget=SearchBudget(top_k=TUNE_REPLAY_TOP_K),
                            device=DEVICE)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    # its survivors, and the model's plan unless one converts alike
    check(res.measured in (TUNE_REPLAY_TOP_K, TUNE_REPLAY_TOP_K + 1)
          and len(measured) - n0 == res.measured,
          f"tune m6: the replay search measured {res.measured}")
    out["replay_search"] = {
        "search_s": replay_s, "step_cost": [float(c) for c in coef],
        "trials": [{"plan": plan_dict(p), "gflops": g,
                    "replay_s": replay(p, db, csr=csr, n_cols=MAIN_N,
                                       backend="cuda")}
                   for p, g in res.trials],
        "winner": plan_dict(res.plan)}
    del res

    # dB = Aᵀ·dY through the transposed format the tuner planned
    tuner = Tuner(cache=cache, n_cols=MAIN_N, device=DEVICE,
                  budget=SearchBudget(top_k=TUNE_T_TOP_K))
    n0 = len(measured)
    t0 = time.perf_counter()
    tl = fmt.transposed(tuner=tuner)
    tl.fmt.on(DEVICE)
    torch.cuda.synchronize()
    out["transposed_tuned_s"] = time.perf_counter() - t0
    out["transposed_trials"] = len(measured) - n0
    # The backward pinned to the tuned plan files its own entry (one key
    # per call, as the reference's cache): one rebuild, timed here.
    t0 = time.perf_counter()
    tp = fmt.transposed(plan=tl.plan)
    out["transposed_pinned_s"] = time.perf_counter() - t0
    check(tp.plan == tl.plan, "tune m6: the pinned backward's Aᵀ has "
          f"plan {tp.plan}, not the tuned {tl.plan}")
    del tp
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    dy = torch.randn((csr.nrows, MAIN_N), generator=gen, device=DEVICE)
    bk = b.clone().requires_grad_(True)
    (db_k,) = torch.autograd.grad(
        loops_spmm(fmt, bk, device=DEVICE, transpose_plan=tl.plan), bk, dy)
    bf = b.clone().requires_grad_(True)
    (db_f,) = torch.autograd.grad(loops_spmm(fmt, bf, device=DEVICE, backend="torch"), bf,
                                  dy)
    with torch.no_grad():
        bnd = loops_spmm(abs_format(tl.fmt), dy.abs(), device=DEVICE,
                         backend="torch")
    out["transposed_plan"] = plan_dict(tl.plan)
    out["db"] = _grad_check("tune m6 dB through the tuned Aᵀ", db_k, db_f,
                            bnd, GCN_TOL)
    del bk, bf, db_k, db_f, bnd, dy
    return out


def host_profile(prof, top: int = 10) -> list:
    """The ``top`` functions of a ``cProfile`` run by cumulative seconds
    (host time; numpy's work counts in the caller that ran it)."""
    import pstats
    stats = pstats.Stats(prof).stats
    rows = sorted(((v[3], f"{k[0].rsplit('/', 1)[-1]}:{k[1]}:{k[2]}")
                   for k, v in stats.items()), reverse=True)
    return [{"fn": name, "cum_s": cum} for cum, name in rows[:top]]


def plan_dict(plan) -> dict:
    import dataclasses
    return dataclasses.asdict(plan)


def lookup_counts(cache) -> dict:
    """The plan cache's lookup buckets."""
    st = cache.stats
    return {"hits": st.hits, "near_hits": st.near_hits,
            "misses": st.misses}


# ---------------------------------------------------------------------------
# phase 5: the served GCN
# ---------------------------------------------------------------------------

def phase_gcn(launches: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import loops_spmm, plan_and_convert, suite
    from repro_torch.models import GCN, gcn_params_from_numpy

    t0 = time.perf_counter()
    adj = suite.gcn_graph(GCN_NODES, GCN_DEGREE, seed=0)
    fmt, plan = plan_and_convert(adj, device=DEVICE)
    setup_s = time.perf_counter() - t0
    validated(fmt, "gcn adjacency")
    rng = np.random.default_rng(0)
    params = {"w0": (rng.standard_normal((F_IN, F_HID)) * 0.1).astype(
                  np.float32),
              "w1": (rng.standard_normal((F_HID, F_OUT)) * 0.1).astype(
                  np.float32)}
    model = GCN(fmt, **gcn_params_from_numpy(params, device=DEVICE))
    xs = [torch.randn((GCN_NODES, F_IN), device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(
                          10 + i)) for i in range(3)]
    torch.cuda.synchronize()

    _reset_counts()
    logits, req_ms = [], []
    with torch.inference_mode():
        for x in xs:
            t0 = time.perf_counter()
            logits.append(model(x))
            torch.cuda.synchronize()
            req_ms.append((time.perf_counter() - t0) * 1e3)
    counts = _read_counts()
    for k, v in counts.items():
        launches[k] += v
        want = 6 if k.endswith("spmm") else 0
        check(v == want, f"gcn: {k} launched {v} times for 3 requests "
              f"(expected {want})")

    errs = []
    with torch.inference_mode():
        for x, got in zip(xs, logits):
            h = torch.relu(loops_spmm(fmt, x @ model.w0, backend="torch"))
            want = loops_spmm(fmt, h @ model.w1, backend="torch")
            check(got.shape == (GCN_NODES, F_OUT)
                  and bool(torch.isfinite(got).all()),
                  f"gcn: bad logits {tuple(got.shape)}")
            err, scale = max_err(got, want)
            check(err <= GCN_TOL * scale, f"gcn logits vs flat torch: err "
                  f"{err:.3g} > {GCN_TOL:g} * {scale:.3g}")
            errs.append(err)
        steady_ms = time_ms(lambda: model(xs[0]), samples=10, reps=3)
    rec = {"phase": "gcn", "nodes": GCN_NODES, "nnz": adj.nnz,
           "widths": [F_IN, F_HID, F_OUT], "r_boundary": plan.r_boundary,
           "setup_s": setup_s, "request_ms": req_ms,
           "steady_request_ms": steady_ms, "launches": counts,
           "max_abs_err": max(errs)}
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 6: GCN training (paper §4.5)
# ---------------------------------------------------------------------------

def _grad_check(name: str, got, want, bnd, tol: float) -> dict:
    """Per-element check |got - want| <= tol * bound, where ``bnd`` >= 0 is
    the summation bound of each element; returns the record."""
    import torch
    d = (got.double() - want.double()).abs()
    rel = float((d / bnd.double().clamp_min(
        torch.finfo(torch.float64).tiny)).max()) if d.numel() else 0.0
    err = float(d.max()) if d.numel() else 0.0
    check(rel <= tol, f"{name}: max |kernel - flat| {err:.3g} is "
          f"{rel:.3g} of its summation bound (> {tol:g})")
    return {"max_abs_err": err, "max_err_of_bound": rel}


def _has_parts(fmt) -> tuple[int, int]:
    return int(fmt.r_boundary > 0), int(fmt.r_boundary < fmt.nrows)


def phase_train_gcn(launches: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import loops_spmm, plan_and_convert, suite
    from repro_torch.models import (GCN, gcn_loss, gcn_params_from_numpy,
                                    sgd_step)

    t0 = time.perf_counter()
    adj = suite.gcn_graph(GCN_NODES, GCN_DEGREE, seed=0)
    fmt, plan = plan_and_convert(adj, device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # The transposed adjacency (Âᵀ for dB): built once, then cached.
    t0 = time.perf_counter()
    tl = fmt.transposed()
    tl.fmt.on(DEVICE)
    torch.cuda.synchronize()
    transpose_build_s = time.perf_counter() - t0
    check(fmt.transposed() is tl, "train_gcn: the transposed format was "
          "built twice")
    validated(fmt, "train_gcn adjacency")
    validated(tl.fmt, "train_gcn transposed adjacency")

    rng = np.random.default_rng(3)
    gen = torch.Generator(device=DEVICE).manual_seed(20)
    x = torch.randn((GCN_NODES, F_IN), generator=gen, device=DEVICE)
    # planted labels, as examples/gcn_train.py makes them (through the
    # flat path: no dense adjacency)
    w_true = torch.as_tensor(rng.standard_normal((F_IN, F_OUT)).astype(
        np.float32)).to(DEVICE)
    with torch.no_grad():
        y = loops_spmm(fmt, x @ w_true, device=DEVICE, backend="torch").argmax(-1)
    params = {"w0": (rng.standard_normal((F_IN, F_HID)) * 0.1).astype(
                  np.float32),
              "w1": (rng.standard_normal((F_HID, F_OUT)) * 0.1).astype(
                  np.float32)}
    model = GCN(fmt, **gcn_params_from_numpy(params, device=DEVICE))
    flat = GCN(fmt, **gcn_params_from_numpy(params, device=DEVICE),
               backend="torch")

    # Step-1 gradients against the flat path's autograd.
    loss_k, _ = gcn_loss(model, x, y)
    g_k = torch.autograd.grad(loss_k, [model.w0, model.w1])
    loss_f, _ = gcn_loss(flat, x, y)
    g_f = torch.autograd.grad(loss_f, [flat.w0, flat.w1])
    with torch.no_grad():
        # Summation bounds of dW1 = hᵀ·Âᵀ·dL and dW0 = xᵀ·Âᵀ·(mask ⊙
        # (Âᵀ·dL)·W1ᵀ), on magnitudes, with the relu mask all-ones.
        tl_abs = abs_format(tl.fmt)
        h = torch.relu(loops_spmm(fmt, x @ flat.w0, device=DEVICE,
                                  backend="torch"))
        logits = loops_spmm(fmt, h @ flat.w1, device=DEVICE, backend="torch")
        dl = torch.softmax(logits, -1)
        dl[torch.arange(GCN_NODES, device=DEVICE), y] -= 1.0
        dl = dl.abs() / GCN_NODES
        b_dz1 = loops_spmm(tl_abs, dl, device=DEVICE, backend="torch")
        b_w1 = h.abs().T @ b_dz1
        b_dz0 = loops_spmm(tl_abs, b_dz1 @ flat.w1.abs().T, device=DEVICE,
                           backend="torch")
        b_w0 = x.abs().T @ b_dz0
    grads = {}
    for name, gk, gf, bnd in (("w0", g_k[0], g_f[0], b_w0),
                              ("w1", g_k[1], g_f[1], b_w1)):
        grads[name] = _grad_check(f"train_gcn d{name}", gk, gf, bnd,
                                  GCN_TOL)
        check(grads[name]["max_abs_err"] <= 1e-4, f"train_gcn d{name}: "
              f"max |kernel - flat| {grads[name]['max_abs_err']:.3g} > 1e-4 "
              "(examples/gcn_train.py's check)")
    loss_k, loss_f = float(loss_k.detach()), float(loss_f.detach())
    check(abs(loss_k - loss_f) <= GCN_TOL * max(1.0, abs(loss_f)),
          f"train_gcn: step-1 loss {loss_k} vs flat {loss_f}")
    del g_k, g_f, h, logits, dl, b_dz1, b_dz0

    # The loop: plain SGD through the kernels, then the flat path from the
    # same start.
    _reset_counts()
    losses, accs, step_ms = [], [], []
    for _ in range(GCN_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, acc = sgd_step(model, x, y, GCN_LR)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        accs.append(float(acc))
    counts = _read_counts()
    fwd, bwd = _has_parts(fmt), _has_parts(tl.fmt)
    want = {"csr_panels_spmm": 2 * (fwd[0] + bwd[0]) * GCN_TRAIN_STEPS,
            "bcsr_panels_spmm": 2 * (fwd[1] + bwd[1]) * GCN_TRAIN_STEPS,
            "csr_sdd_panels": 0, "bcsr_sdd_panels": 0, "flash_attention": 0,
            "wkv6": 0, "wkv6_bwd": 0}
    for k, v in counts.items():
        launches[k] += v
        check(v == want[k], f"train_gcn: {k} launched {v} times in "
              f"{GCN_TRAIN_STEPS} steps (expected {want[k]})")
    flat_losses = []
    t0 = time.perf_counter()
    for _ in range(GCN_TRAIN_STEPS):
        flat_losses.append(float(sgd_step(flat, x, y, GCN_LR)[0]))
    torch.cuda.synchronize()
    flat_step_ms = (time.perf_counter() - t0) * 1e3 / GCN_TRAIN_STEPS
    traj = max(abs(a - b) / max(1.0, abs(b))
               for a, b in zip(losses, flat_losses))
    check(all(np.isfinite(losses)) and traj <= GCN_TOL,
          f"train_gcn: loss trajectory {losses} vs flat {flat_losses}")
    check(losses[-1] < losses[0], f"train_gcn: the loss did not fall "
          f"({losses[0]} -> {losses[-1]})")
    profile = profile_step(lambda: sgd_step(model, x, y, GCN_LR))
    rec = {"phase": "train_gcn", "nodes": GCN_NODES, "nnz": adj.nnz,
           "widths": [F_IN, F_HID, F_OUT], "steps": GCN_TRAIN_STEPS,
           "lr": GCN_LR, "r_boundary": plan.r_boundary,
           "r_boundary_transposed": tl.fmt.r_boundary,
           "setup_s": setup_s, "transpose_build_s": transpose_build_s,
           "step_ms": step_ms,
           "steady_step_ms": statistics.median(step_ms[1:]),
           "flat_step_ms": flat_step_ms, "launches": counts,
           "losses": losses, "flat_losses": flat_losses, "accuracy": accs,
           "max_loss_diff_rel": traj, "step1_grads": grads,
           "profiled_step": profile}
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 7: sparse-FFN training (llama3.2-1b MLP up-projection)
# ---------------------------------------------------------------------------

def phase_train_ffn(launches: dict) -> list:
    import numpy as np
    import torch
    from repro_torch.core import (csr_from_dense, loops_spmm_values,
                                  transposed_values)
    from repro_torch.core.formats import csr_slice_rows
    from repro_torch.kernels import spmm_sdd
    from repro_torch.models import magnitude_prune, sparse_linear_from_dense

    out = []
    for dname in FFN_DTYPES:
        dt = getattr(torch, dname)
        tol = TOL[dname]
        rng = np.random.default_rng(4)
        w = (rng.standard_normal((FFN_D_OUT, FFN_D_IN)) * 0.02).astype(
            np.float32)
        wt = torch.from_numpy(w).to(dt)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        layer = sparse_linear_from_dense(wt, FFN_SPARSITY, device=DEVICE)
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0
        fmt = layer.fmt
        t0 = time.perf_counter()
        tl = fmt.transposed(dtype=dt)
        tl.fmt.on(DEVICE)
        tl.maps_on(DEVICE)
        torch.cuda.synchronize()
        transpose_build_s = time.perf_counter() - t0
        validated(fmt, f"train_ffn {dname} weight")
        validated(tl.fmt, f"train_ffn {dname} transposed weight")
        gen = torch.Generator(device=DEVICE).manual_seed(30)
        x = torch.randn(FFN_X_SHAPE, generator=gen, device=DEVICE).to(dt)
        x.requires_grad_(True)
        params = [layer.csr_vals, layer.bcsr_vals, x]

        # Gradients against the flat path's autograd, with one cotangent
        # (that of sum(y²) at the flat output) for both.  The flat path runs
        # in fp32 on the same values (bf16 is exact in fp32): in bf16 its
        # autograd would round each gathered product's gradient to bf16
        # before the scatter, a weaker oracle than the kernel path.
        def flat(cv, bv, xx):
            return loops_spmm_values(fmt, cv, bv, xx.transpose(-1, -2),
                                     device=DEVICE,
                                     backend="torch").transpose(-1, -2)
        flat_in = [t.detach().float().requires_grad_(True) for t in params]
        y_f = flat(*flat_in)
        y_k = layer(x)
        dy = (2.0 * y_f.detach()).to(dt)
        g_k = torch.autograd.grad(y_k, params, dy)
        g_f = torch.autograd.grad(y_f, flat_in, dy.float())
        abs_in = [t.detach().abs().requires_grad_(True) for t in flat_in]
        y_abs = flat(*abs_in)
        checks = {"y": _grad_check(f"train_ffn {dname} y", y_k.detach(),
                                   y_f.detach(), y_abs.detach(), tol)}
        bnds = torch.autograd.grad(y_abs, abs_in, dy.float().abs())
        for name, gk, gf, bnd in zip(("d_csr_vals", "d_bcsr_vals", "dx"),
                                     g_k, g_f, bnds):
            check(gk.dtype == dt and gk.shape == gf.shape,
                  f"train_ffn {dname} {name}: {gk.dtype} {gk.shape} vs "
                  f"{dt} {gf.shape}")
            checks[name] = _grad_check(f"train_ffn {dname} {name}", gk, gf,
                                       bnd, tol)
        del y_k, y_f, g_k, g_f, y_abs, bnds, abs_in, flat_in

        # B3 and B4 alone, at the backward's shapes: dY is the fp32
        # cotangent of the (d_out, tokens) product, B the activation.
        dev = fmt.on(DEVICE)
        b3 = x.detach().transpose(-1, -2).contiguous()
        dy3 = dy.transpose(-1, -2).float().contiguous()
        r_b, br = fmt.r_boundary, fmt.bcsr_part.br
        nrows_b = fmt.nrows - r_b
        csr = csr_from_dense(magnitude_prune(w if dname == "float32" else
                                             wt.float().numpy(),
                                             FFN_SPARSITY))
        zn = b3.shape[0] * b3.shape[2]
        bt = b3.permute(0, 2, 1).reshape(zn, FFN_D_IN)
        kernels = {}
        for name, panels, kbr, rows, run, plain, part_rows in (
                ("csr_sdd_panels", dev.csr, 1, r_b,
                 lambda: spmm_sdd.csr_sdd_panels(
                     dev.csr.rows, dev.csr.cols, dev.csr.mask, dy3, b3,
                     blocks=dev.csr.sdd_blocks),
                 lambda d=dy3, b=b3: spmm_sdd.csr_sdd_panels_plain(
                     dev.csr.rows, dev.csr.cols, dev.csr.mask, d, b),
                 (0, r_b)),
                ("bcsr_sdd_panels", dev.bcsr, br, nrows_b,
                 lambda: spmm_sdd.bcsr_sdd_panels(
                     dev.bcsr.rows, dev.bcsr.cols, dev.bcsr.mask, dy3, b3,
                     br=br, row_offset=r_b, nrows=nrows_b,
                     units=dev.bcsr.units),
                 lambda d=dy3, b=b3: spmm_sdd.bcsr_sdd_panels_plain(
                     dev.bcsr.rows, dev.bcsr.cols, dev.bcsr.mask, d, b,
                     br=br, row_offset=r_b, nrows=nrows_b),
                 (r_b, fmt.nrows))):
            got = run()
            again = run()
            want = plain()
            absprod = plain(d=dy3.abs(), b=b3.abs())
            torch.cuda.synchronize()
            k_err, k_rel = sum_err(got, want, absprod)
            check(k_rel <= tol, f"train_ffn {dname} {name} vs plain: err "
                  f"{k_err:.3g}, {k_rel:.3g} of |dY||B| > {tol:g}")
            check(torch.equal(got, again), f"train_ffn {dname} {name}: two "
                  "calls differ")
            dy_rows = dy3[:, part_rows[0]:part_rows[1]].permute(
                1, 0, 2).reshape(part_rows[1] - part_rows[0], zn)
            lib, lib_what = library_sdd_ms(
                csr_slice_rows(csr, *part_rows), dy_rows, bt, dt)
            kernels[name] = {
                "ms": time_ms(run),
                "plain_ms": time_ms(plain, samples=3, reps=1, warmup=1),
                "library_ms": lib, "library": lib_what,
                "max_abs_err": k_err, "max_err_of_absprod": k_rel,
                "bitwise_repeatable": True,
                "npanels": int(panels.rows.numel()),
                **sdd_bound(panels, dy3, b3, got, br=kbr, dy_rows=rows,
                            dtype=dname)}
            if name == "csr_sdd_panels":
                kernels[name].update(block_counts(panels.sdd_blocks))
            kernels[name].update(rate(kernels[name]))
            del got, again, want, absprod, dy_rows
        del dy, dy3, bt
        # The live values' per-step copies: the scatter into both parts'
        # panels (forward) and the carry into Wᵀ's layout (dx).
        cv, bv = layer.csr_vals.detach(), layer.bcsr_vals.detach()
        scatter_ms = time_ms(lambda: (dev.csr.scatter_values(cv),
                                      dev.bcsr.scatter_values(bv)))
        carry_ms = time_ms(lambda: transposed_values(tl, cv, bv))

        # A few SGD steps on the stored values (x stays fixed), loss sum(y²).
        _reset_counts()
        losses, step_ms = [], []
        for _ in range(FFN_STEPS):
            t0 = time.perf_counter()
            loss = layer(x).float().square().sum()
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                layer.csr_vals.sub_(FFN_LR * grads[0])
                layer.bcsr_vals.sub_(FFN_LR * grads[1])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.detach()))
        counts = _read_counts()
        fw, bw = _has_parts(fmt), _has_parts(tl.fmt)
        want_n = {"csr_panels_spmm": (fw[0] + bw[0]) * FFN_STEPS,
                  "bcsr_panels_spmm": (fw[1] + bw[1]) * FFN_STEPS,
                  "csr_sdd_panels": fw[0] * FFN_STEPS,
                  "bcsr_sdd_panels": fw[1] * FFN_STEPS,
                  "flash_attention": 0, "wkv6": 0, "wkv6_bwd": 0}
        for k, v in counts.items():
            launches[k] += v
            check(v == want_n[k], f"train_ffn {dname}: {k} launched {v} "
                  f"times in {FFN_STEPS} steps (expected {want_n[k]})")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"train_ffn {dname}: losses {losses}")
        profile = profile_step(lambda: torch.autograd.grad(
            layer(x).float().square().sum(), params))
        rec = {"phase": "train_ffn", "dtype": dname,
               "shape": [FFN_D_OUT, FFN_D_IN], "sparsity": FFN_SPARSITY,
               "x": list(FFN_X_SHAPE), "nnz": csr.nnz,
               "r_boundary": r_b, "br": br, "panel_g": fmt.panel_g,
               "r_boundary_transposed": tl.fmt.r_boundary,
               "br_transposed": tl.fmt.bcsr_part.br,
               "convert_s": convert_s,
               "transpose_build_s": transpose_build_s,
               "step_ms": step_ms, "scatter_values_ms": scatter_ms,
               "transposed_values_ms": carry_ms,
               "losses": losses, "lr": FFN_LR,
               "launches": counts, "grads": checks, "kernels": kernels,
               "profiled_step": profile,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        phase(rec)
        out.append(rec)
        del layer, x, params, grads, loss, fmt, tl, dev, b3
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: serving llama3.2-1b at full width
# ---------------------------------------------------------------------------

def flash_bound(q, k, *, causal: bool, window: int = 0) -> dict:
    """Least time of one B5 call: Q, K, V read once and O written once;
    the QKᵀ and P·V flops of the (query, key) pairs the mask keeps
    (``kernels/flash_attention.py::kept_pairs``: S(S+1)/2 of S² per head
    when causal at Sq == Sk, the window's span, the prefix offset's), at
    the dtype's peak."""
    from repro_torch.kernels.flash_attention import kept_pairs
    bsz, seq, heads, hd = q.shape
    pairs = float(kept_pairs(seq, k.shape[1], causal, window))
    flops = 4.0 * hd * pairs * bsz * heads
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return bound(bytes_moved=float(nbytes), flops=flops,
                 dtype=str(q.dtype).replace("torch.", ""))


def rate(rec: dict) -> dict:
    """``tflops`` (the record's flops over its ``ms``) and
    ``share_of_bound`` (``bound_ms`` over ``ms``)."""
    return {"tflops": rec["flops"] / rec["ms"] / 1e9,
            "share_of_bound": rec["bound_ms"] / rec["ms"]}


def _lm_logits_err(name: str, got, want) -> float:
    """Check fp32 logits against the reference path's at ``LM_TOL``;
    returns the error relative to max(1, max |want|)."""
    import torch
    err, scale = max_err(got, want)
    check(bool(torch.isfinite(got).all()) and err <= LM_TOL * scale,
          f"{name}: max |diff| {err:.3g} > {LM_TOL:g} * {scale:.3g}")
    return err / scale


def _b5_alone(dt) -> dict:
    """B5 at the serving shape on seeded tensors, causal: its time, its
    plain version's, ``scaled_dot_product_attention``'s on the same tensors
    (the yardstick; the port never calls it), its error against the plain
    version, and its bound; under ``"variants"`` the same at the serving
    batch without the causal mask and at hd 128 (16 heads, 4 kv-heads)."""
    _, _, heads, kv, hd = FLASH_SHAPES[-1]
    rec = _b5_timed(dt, heads, kv, hd, True, plain=True)
    rec["variants"] = [_b5_timed(dt, heads, kv, hd, False),
                       _b5_timed(dt, heads // 2, kv // 2, 2 * hd, True)]
    return rec


def _b5_timed(dt, heads: int, kv: int, hd: int, causal: bool, *,
              plain: bool = False) -> dict:
    """One B5 record of :func:`_b5_alone` at (LM_BATCH, LM_PROMPT, heads,
    hd); the plain version is timed only when ``plain``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as b5
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    q = torch.randn((LM_BATCH, LM_PROMPT, heads, hd), generator=gen,
                    device=DEVICE).to(dt)
    k = torch.randn((LM_BATCH, LM_PROMPT, kv, hd), generator=gen,
                    device=DEVICE).to(dt)
    v = torch.randn((LM_BATCH, LM_PROMPT, kv, hd), generator=gen,
                    device=DEVICE).to(dt)
    got = b5.flash_attention(q, k, v, causal=causal)
    want = b5.flash_attention_plain(q, k, v, causal=causal)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)
    lib = sdpa().transpose(1, 2)
    torch.cuda.synchronize()
    err, scale = max_err(got, want)
    dname = str(dt).replace("torch.", "")
    rerr = row_err(got, want)
    check(err <= FLASH_TOL[dname] * scale and rerr <= FLASH_ROW_TOL[dname],
          f"flash_attention alone {tuple(q.shape)} causal={causal}: err "
          f"{err:.3g}, row err {rerr:.3g}")
    lib_err, _ = max_err(lib, want)
    rec = {"dtype": str(dt), "shape": list(q.shape), "kv_heads": kv,
           "causal": causal,
           "ms": time_ms(lambda: b5.flash_attention(q, k, v, causal=causal)),
           "plain_ms": time_ms(lambda: b5.flash_attention_plain(
               q, k, v, causal=causal), samples=3, reps=1, warmup=1)
           if plain else None,
           "library_ms": time_ms(sdpa),
           "library": "torch.nn.functional.scaled_dot_product_attention("
                      f"is_causal={causal}, enable_gqa=True)",
           "library_max_abs_err_vs_plain": lib_err,
           "max_abs_err": err, "max_err_rel": err / scale,
           "max_row_err": rerr, "library_max_row_err": row_err(lib, want),
           "mean_abs_plain": float(want.double().abs().mean()),
           **flash_bound(q, k, causal=causal)}
    rec.update(rate(rec))
    return rec


def _wall_ms(fn) -> float:
    """Host-clock milliseconds of one call of ``fn`` that ends in a copy
    to the host (which waits for the device)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def phase_serve_lm(launches: dict) -> dict:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.queue import (DEFAULT_LEN_QUANTUM, ExecutorPool,
                                         ServeQueue, pad_cache)
    from repro_torch.serve.scheduler import SchedulerConfig

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(LM_ARCH)
    layers = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(LM_SEED),
        device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = api.num_params(params)
    rng = np.random.default_rng(LM_SEED + 1)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    # The pool's bucket for the served group (the queue rounds the budget
    # up to its quantum), warmed before traffic: its slot's prefill and
    # decode graphs are captured here, outside the counts.
    max_len = LM_PROMPT + -(-LM_GEN // DEFAULT_LEN_QUANTUM) * \
        DEFAULT_LEN_QUANTUM
    pool = ExecutorPool(cfg, params)
    t0 = time.perf_counter()
    pool.warm([(LM_BATCH, LM_PROMPT, max_len)])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    bucket = pool.bundle(LM_BATCH, LM_PROMPT, max_len)
    check(len(pool) == 1 and pool.slots == 1,
          f"serve_lm: warm() built {len(pool)} buckets, {pool.slots} slots")

    queue = ServeQueue(cfg, params, config=SchedulerConfig(max_batch=8),
                       pool=pool)
    _reset_counts()
    t0 = time.perf_counter()
    reqs = [queue.submit(row.tolist(), LM_GEN) for row in prompts]
    done = queue.drain()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = _read_counts()
    n_prefill = queue.sched.counters["prefill_batches"]
    for k, v in counts.items():
        launches[k] += v
        want = layers * n_prefill if k == "flash_attention" else 0
        check(v == want, f"serve_lm: {k} launched {v} times for {n_prefill} "
              f"prefill replays (expected {want})")
    check(n_prefill == 1 and len(done) == LM_BATCH and pool.slots == 1,
          f"serve_lm: {len(done)} of {LM_BATCH} requests in {n_prefill} "
          f"prefill calls, {pool.slots} slots")
    served = np.array([r.tokens for r in reqs])
    check(served.shape == (LM_BATCH, LM_GEN) and served.min() >= 0
          and served.max() < cfg.vocab_size,
          f"serve_lm: tokens {served.shape} in [{served.min()}, "
          f"{served.max()}]")
    # allocated: live tensors (static caches, graph outputs); reserved:
    # also the graph pool's and the allocator's cached blocks
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    peak_reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    decode_ms = [s * 1e3 for s in queue.engine_s["decode"]]
    prefill_ms = [s * 1e3 for s in queue.engine_s["prefill"]]
    n_tokens = int(served.size)

    # bf16, teacher-forced with the served tokens: the greedy tokens of the
    # eager path (B5, one launch per operation, as the queue ran before the
    # pool), which must equal the served (graphed) ones, and of the plain
    # attention path (their share of agreement).
    prompts_t = torch.as_tensor(prompts, device=DEVICE)
    served_t = torch.as_tensor(served, device=DEVICE)

    def greedy(backend):
        cache, logits = api.prefill(cfg, params, {"tokens": prompts_t},
                                    backend=backend)
        toks = [logits[:, :cfg.vocab_size].argmax(-1)]
        cache = pad_cache(cfg, cache, max_len)
        for i in range(LM_GEN - 1):
            cache, logits = api.decode_step(
                cfg, params, cache, served_t[:, i:i + 1], LM_PROMPT + i)
            toks.append(logits[:, :cfg.vocab_size].argmax(-1))
        return torch.stack(toks, 1) == served_t
    same_eager = greedy(None)
    agree_eager = float(same_eager.float().mean())
    check(bool(same_eager.all()), f"serve_lm: the graphed streams differ "
          f"from the eager path's (agreement {agree_eager:.4f})")
    before = _read_counts()
    agree = float(greedy("torch").float().mean())
    check(_read_counts() == before, "serve_lm: the plain path launched a "
          "kernel")

    # Graphed against eager at the bucket's shapes and on the slot's cache,
    # in turns: prefill (3 each), then every decode position of the run.
    slot = pool.acquire(bucket)
    prefill_g, prefill_e, decode_g, decode_e = [], [], [], []
    for _ in range(3):
        prefill_g.append(_wall_ms(lambda: slot.prefill_fn(
            {"tokens": prompts})[1].cpu()))
        prefill_e.append(_wall_ms(lambda: api.prefill(cfg, params, {
            "tokens": torch.as_tensor(prompts, device=DEVICE)})[1].cpu()))
    slot.prefill_fn({"tokens": prompts})
    for i in range(LM_GEN - 1):
        tok = served[:, i:i + 1]
        decode_g.append(_wall_ms(lambda: slot.serve_fn(
            tok, LM_PROMPT + i)[1].cpu()))
        decode_e.append(_wall_ms(lambda: api.decode_step(
            cfg, params, slot.cache, torch.as_tensor(tok, device=DEVICE),
            LM_PROMPT + i)[1].cpu()))
    # One prefill call's and one decode step's kernels by device time (B5's
    # share of the prefill; the device's idle share of a decode step,
    # eager and replayed).
    profile = profile_step(lambda: api.prefill(cfg, params,
                                               {"tokens": prompts_t}))
    b5_share = sum(r["device_ms"] for r in profile["top"]
                   if "flash_wgmma_kernel" in r["name"]
                   or "flash_fwd_kernel" in r["name"])
    last = served[:, -1:]
    profile_dec = profile_step(lambda: api.decode_step(
        cfg, params, slot.cache, torch.as_tensor(last, device=DEVICE),
        LM_PROMPT + LM_GEN - 1))
    profile_rep = profile_step(lambda: slot.serve_fn(
        last, LM_PROMPT + LM_GEN - 1))
    pool.release(bucket, slot)
    pool_rec = {"warm_s": warm_s, "buckets": len(pool), "builds": pool.builds,
                "slots": pool.slots, "build_s": pool.build_s}
    del queue, pool, slot, params
    torch.cuda.empty_cache()

    # fp32: logits through B5 and through the plain path, teacher-forced;
    # the graphed prefill and decode steps against the eager ones; decode
    # against prefill of one more token (S + 1 = 2049: B5's ragged edge).
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = api.init_params(
        cfg32, torch.Generator(device=DEVICE).manual_seed(LM_SEED),
        device=DEVICE)
    toks = prompts_t[:1]
    teacher = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (1, LM_CHECK_STEPS)),
                              device=DEVICE)

    def run(backend):
        cache, logits = api.prefill(cfg32, params32, {"tokens": toks},
                                    backend=backend)
        outs = [logits]
        cache = pad_cache(cfg32, cache, LM_PROMPT + LM_CHECK_STEPS)
        for i in range(LM_CHECK_STEPS):
            cache, logits = api.decode_step(cfg32, params32, cache,
                                            teacher[:, i:i + 1],
                                            LM_PROMPT + i)
            outs.append(logits)
        return outs
    pool32 = ExecutorPool(cfg32, params32)
    b32 = pool32.bundle(1, LM_PROMPT, LM_PROMPT + LM_CHECK_STEPS)
    slot32 = pool32.acquire(b32)
    n0 = _kernel_fns()["flash_attention"].launches
    graph_outs = [slot32.prefill_fn({"tokens": toks})[1].clone()]
    graph_outs += [slot32.serve_fn(teacher[:, i:i + 1],
                                   LM_PROMPT + i)[1].clone()
                   for i in range(LM_CHECK_STEPS)]
    check(_kernel_fns()["flash_attention"].launches == n0 + layers,
          "serve_lm fp32: the graphed prefill did not count B5 once a layer")
    kernel_outs = run(None)
    check(_kernel_fns()["flash_attention"].launches == n0 + 2 * layers,
          "serve_lm fp32: the kernel path did not launch B5 once a layer")
    plain_outs = run("torch")
    torch.cuda.synchronize()
    step_errs = [_lm_logits_err(f"serve_lm fp32 logits step {i}", g, w)
                 for i, (g, w) in enumerate(zip(kernel_outs, plain_outs))]
    graph_errs = [_lm_logits_err(f"serve_lm fp32 graphed step {i}", g, w)
                  for i, (g, w) in enumerate(zip(graph_outs, kernel_outs))]
    _, longer = api.prefill(cfg32, params32, {"tokens": torch.cat(
        [toks, teacher[:, :1]], 1)})
    dec_err = _lm_logits_err("serve_lm fp32 decode(S) vs prefill(S+1)",
                             kernel_outs[1], longer)
    del params32, kernel_outs, plain_outs, graph_outs, longer, pool32, slot32
    torch.cuda.empty_cache()

    alone = _b5_alone(torch.bfloat16)
    alone_fp32 = _b5_alone(torch.float32)
    med = statistics.median
    rec = {"phase": "serve_lm", "arch": LM_ARCH, "params": n_params,
           "dtype": "bfloat16", "layers": layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "vocab": cfg.vocab_size, "requests": LM_BATCH,
           "prompt_len": LM_PROMPT, "gen_len": LM_GEN,
           "bf16_reduced_precision_reduction": False,
           "init_s": init_s, "pool": pool_rec, "serve_s": serve_s,
           "prefill_calls": n_prefill,
           "prefill_ms": prefill_ms,
           "decode_steps": len(decode_ms),
           "decode_ms_median": med(decode_ms),
           "decode_ms": decode_ms,
           "ttft_ms": [r.wall_ttft_s * 1e3 for r in reqs],
           "tokens": n_tokens, "tokens_per_s": n_tokens / serve_s,
           "decode_tokens_per_s": LM_BATCH / (med(decode_ms) / 1e3),
           "peak_mem_gb": peak_gb, "peak_reserved_gb": peak_reserved_gb,
           "launches": counts,
           "graphed_vs_eager": {
               "prefill_ms": prefill_g, "eager_prefill_ms": prefill_e,
               "prefill_ms_median": med(prefill_g),
               "eager_prefill_ms_median": med(prefill_e),
               "decode_ms": decode_g, "eager_decode_ms": decode_e,
               "decode_ms_median": med(decode_g),
               "eager_decode_ms_median": med(decode_e)},
           "streams_equal_eager_bf16": True,
           "greedy_agreement_bf16_vs_eager": agree_eager,
           "greedy_agreement_bf16_vs_plain": agree,
           "fp32_logits_err_rel": step_errs,
           "fp32_graphed_vs_eager_err_rel": graph_errs,
           "fp32_decode_vs_prefill_err_rel": dec_err,
           "b5_alone": alone, "b5_alone_fp32": alone_fp32,
           "profiled_prefill": profile,
           "profiled_prefill_b5_device_ms": b5_share,
           "profiled_decode_step": profile_dec,
           "profiled_decode_replay": profile_rep}
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 9: the launcher with --obs (obs/, the plan-cache warm-up, faults)
# ---------------------------------------------------------------------------

def _obs_value(recs, kind, metric, /, **labels):
    """A metric's value (a histogram's count) in a loaded capture, 0 when
    absent."""
    for r in recs:
        if r["kind"] == kind and r["metric"] == metric \
                and r["labels"] == {k: str(v) for k, v in labels.items()}:
            return r["count"] if kind == "hist" else r["value"]
    return 0


def _served(queue) -> dict:
    """Tokens and wall-clock numbers of a finished launcher run."""
    reqs = sorted(queue.completed, key=lambda r: r.rid)
    n_tokens = sum(r.tokens_generated for r in reqs)
    span = max(r.wall_finish_s for r in reqs) - min(r.wall_arrival_s
                                                    for r in reqs)
    return {"tokens": [list(map(int, r.tokens)) for r in reqs],
            "prefill_ms": [t * 1e3 for t in queue.engine_s["prefill"]],
            "decode_ms_median": statistics.median(
                queue.engine_s["decode"]) * 1e3,
            "ttft_ms": [r.wall_ttft_s * 1e3 for r in reqs],
            "tokens_per_s": n_tokens / span, "prefill_calls":
            queue.sched.counters["prefill_batches"],
            "decode_calls": len(queue.engine_s["decode"]),
            "pool_buckets": len(queue.pool), "pool_slots": queue.pool.slots}


def _warm_csr(w):
    """``warm_spmm_plan_cache``'s pruned CSR of one ``wi``ᵀ (host fp32)."""
    from repro_torch.core.formats import csr_from_dense
    from repro_torch.launch.serve import warm_spmm_plan_cache
    from repro_torch.models.sparse_ffn import magnitude_prune
    from repro_torch.resilience.validate import validate_csr
    sparsity = warm_spmm_plan_cache.__kwdefaults__["sparsity"]
    csr, _ = validate_csr(csr_from_dense(magnitude_prune(w, sparsity)),
                          repair="drop")
    return csr


def _warm_key(csr) -> str:
    """The warm-up's plan-cache key of ``csr``."""
    from repro_torch.launch.serve import warm_spmm_plan_cache
    from repro_torch.tune import cache_key, fingerprint
    n_cols = warm_spmm_plan_cache.__kwdefaults__["n_cols"]
    return cache_key(fingerprint(csr), n_cols=n_cols, dtype=csr.vals.dtype,
                     backend="cuda")


def _pool_plan_check(csr, rec) -> dict:
    """``csr`` converted with the serving pool's plan ``rec``, its
    ``loops_spmm`` on the card at the warm-up's N against the flat path at
    ``TOL`` of |A|·|B| and against a second call (bitwise equal); each
    kernel of the plan's parts must launch in both calls."""
    import torch
    from repro_torch.core import loops_spmm
    from repro_torch.core.formats import loops_from_csr
    from repro_torch.launch.serve import warm_spmm_plan_cache
    from repro_torch.tune import plan_from_record

    n_cols = warm_spmm_plan_cache.__kwdefaults__["n_cols"]
    plan = plan_from_record(rec, csr.nrows)
    fmt = validated(loops_from_csr(csr, plan.r_boundary, plan.br,
                                   panel_g=plan.panel_g, macro_m=plan.macro_m,
                                   pipeline_depth=plan.pipeline_depth),
                    "serve_obs pool plan")
    fmt.on(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    b = torch.randn((csr.ncols, n_cols), generator=gen, device=DEVICE)
    _reset_counts()
    y = loops_spmm(fmt, b, device=DEVICE)
    again = loops_spmm(fmt, b, device=DEVICE)
    torch.cuda.synchronize()
    counts = _read_counts()
    want = loops_spmm(fmt, b, device=DEVICE, backend="torch")
    absprod = loops_spmm(abs_format(fmt), b.abs(), device=DEVICE,
                         backend="torch")
    err, rel = sum_err(y, want, absprod)
    check(rel <= TOL["float32"], f"serve_obs: loops_spmm at the pool's plan "
          f"vs flat: err {err:.3g}, {rel:.3g} of |A||B| > {TOL['float32']:g}")
    check(torch.equal(y, again), "serve_obs: two loops_spmm calls at the "
          "pool's plan differ")
    for k, rows in (("csr_panels_spmm", plan.r_boundary),
                    ("bcsr_panels_spmm", csr.nrows - plan.r_boundary)):
        check(counts[k] == (2 if rows else 0), f"serve_obs: {k} launched "
              f"{counts[k]} times in two calls at {rows} rows of its part")
    return {"plan": plan_dict(plan), "n_cols": n_cols, "nnz": csr.nnz,
            "launches": {k: v for k, v in counts.items() if v},
            "max_abs_err": err, "max_err_of_absprod": rel,
            "bitwise_repeatable": True}


def phase_serve_obs(launches: dict, lm_rec: dict, out_dir,
                    work_dir) -> dict:
    """``python -m repro_torch.launch.serve --obs`` at phase serve_lm's
    model and batch (16 generated tokens): the plan-cache warm-up (layer 0
    searches, layers 1-15 hit; B1/B2 launch in its trials and validation
    SpMMs for the parts the plans have, every launch seen by a capture;
    the pool installs each distinct key once, a second warm-up none), the
    capture's histograms against the requests and calls, the tokens
    against a run without obs, and a run with one injected ``serve.step``
    fault (retried, counted, the same tokens); then layer 0's
    ``loops_spmm`` at the pool's plan against the flat path
    (:func:`_pool_plan_check`).  The plan caches live in ``work_dir``; the
    captures go to ``out_dir``, else ``work_dir``."""
    import os

    import torch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.obs import Obs, load_obs
    from repro_torch.resilience import inject

    os.environ["REPRO_TUNE_CACHE"] = str(pathlib.Path(work_dir) / "serve")
    cap_dir = pathlib.Path(out_dir or work_dir)
    argv = ["--arch", LM_ARCH, "--device", DEVICE, "--batch", str(LM_BATCH),
            "--prompt-len", str(LM_PROMPT), "--gen-len", str(OBS_GEN),
            "--seed", str(LM_SEED), "--max-batch", "8", "--obs-dir",
            str(cap_dir)]
    _reset_counts()

    # 1. --obs: the warm-up, then serving under the capture
    t0 = time.perf_counter()
    q_obs = launch_serve.main(argv + ["--obs", "chip_smoke_serve_obs"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    recs = load_obs(cap_dir / "chip_smoke_serve_obs.jsonl")
    cfg = q_obs.cfg
    layers = cfg.num_layers
    served_obs = _served(q_obs)
    warm_spans = [r for r in recs if r["kind"] == "span"
                  and r["name"] == "serve.warm_plan"]
    warm = {k: _obs_value(recs, "gauge", f"tune.cache.{k}",
                          cache="serve-warm")
            for k in ("hits", "near_hits", "misses", "hit_rate")}
    installed = _obs_value(recs, "gauge", "serve.prewarmed_plans")
    check(len(warm_spans) == layers and warm["misses"] == 1
          and warm["hits"] + warm["near_hits"] == layers - 1,
          f"serve_obs: warm-up lookups {warm} over {layers} layers")
    check(installed >= 1 and _obs_value(
        recs, "gauge", "tune.cache.prewarmed", cache="serve-pool")
        == installed, f"serve_obs: the pool installed {installed}")
    n_req, n_pre = LM_BATCH, served_obs["prefill_calls"]
    n_dec = served_obs["decode_calls"]
    hists = {m: _obs_value(recs, "hist", m) for m in (
        "serve.prefill_us", "serve.ttft_us", "serve.request_us",
        "serve.decode_token_us")}
    check(hists["serve.prefill_us"] == hists["serve.ttft_us"]
          == hists["serve.request_us"] == n_req
          and hists["serve.decode_token_us"] == n_req * (OBS_GEN - 1)
          and _obs_value(recs, "hist", "step.wall_us", op="prefill") == n_pre
          and _obs_value(recs, "hist", "step.wall_us", op="decode") == n_dec
          and _obs_value(recs, "counter", "serve.requests") == n_req
          and _obs_value(recs, "counter", "serve.prefill_calls") == n_pre
          and _obs_value(recs, "counter", "serve.decode_calls") == n_dec,
          f"serve_obs: histograms {hists} against {n_req} requests, "
          f"{n_pre} prefill and {n_dec} decode calls")
    check(len(served_obs["tokens"]) == n_req
          and all(len(t) == OBS_GEN for t in served_obs["tokens"]),
          "serve_obs: not every request got its tokens")

    # 2. a second warm-up into the same pool installs nothing
    warm2 = Obs(source="chip_smoke_rewarm")
    t0 = time.perf_counter()
    with warm2.attach_engine():
        pool = launch_serve.warm_spmm_plan_cache(cfg, q_obs.params, warm2)
    torch.cuda.synchronize()
    rewarm_s = time.perf_counter() - t0
    pool_plans = [rec["plan"] for rec in pool._load().values()]
    # layer 0's wiᵀ and the pool's record of it, for the check of B1/B2 at
    # this path's plan and shapes below
    w0 = q_obs.params.layers[0].mlp.wi.detach().float().cpu().numpy().T
    csr0 = _warm_csr(w0)
    rec0 = pool.peek(_warm_key(csr0))
    check(rec0 is not None, "serve_obs: the pool holds no plan for layer 0")
    re_stats = {r["metric"]: r["value"] for r in warm2.records()
                if r["kind"] == "gauge"
                and r["labels"].get("cache") == "serve-warm"}
    check(pool.stats.prewarmed == 0
          and warm2.metrics.find("gauge", "serve.prewarmed_plans").value == 0
          and re_stats["tune.cache.misses"] == 0,
          f"serve_obs: the second warm-up installed {pool.stats.prewarmed}, "
          f"lookups {re_stats}")
    del q_obs, pool
    torch.cuda.empty_cache()

    # 3. the same run without obs (and without the warm-up): same tokens
    q_plain = launch_serve.main(argv)
    served_plain = _served(q_plain)
    check(served_plain["tokens"] == served_obs["tokens"],
          "serve_obs: the tokens with obs differ from those without")
    del q_plain
    torch.cuda.empty_cache()

    # 4. one injected serve.step fault: retried, counted, same tokens
    os.environ[inject.ENV_VAR] = OBS_FAULT_PLAN
    try:
        q_fault = launch_serve.main(argv + ["--obs", "chip_smoke_serve_fault",
                                            "--no-warm-spmm-cache"])
    finally:
        del os.environ[inject.ENV_VAR]
        inject.set_plan(None)
    served_fault = _served(q_fault)
    recs_f = load_obs(cap_dir / "chip_smoke_serve_fault.jsonl")
    retries = _obs_value(recs_f, "counter", "serve.retries")
    fired = _obs_value(recs_f, "counter", "inject.fired", site="serve.step",
                       kind="raise")
    check(retries == 1 and fired == 1
          and served_fault["tokens"] == served_obs["tokens"],
          f"serve_obs: the injected fault gave {retries} retries, {fired} "
          "fired faults, or other tokens")
    del q_fault
    torch.cuda.synchronize()
    counts = _read_counts()
    runs = n_pre + served_plain["prefill_calls"] + \
        served_fault["prefill_calls"]
    # each launcher run's pool built its slot on first need: one eager
    # prefill before the captures, then a replay per prefill call
    slots = served_obs["pool_slots"] + served_plain["pool_slots"] + \
        served_fault["pool_slots"]
    # B1/B2 run in the two warm-ups only (the trials and the validation
    # SpMMs), for the parts their plans have; the captures saw each launch.
    warm_disp = {part: _obs_value(recs, "counter", "engine.dispatch",
                                  backend="cuda", impl="panels", op="spmm",
                                  part=part)
                 + _dispatches(warm2)[part] for part in ("csr", "bcsr")}
    check(counts["csr_panels_spmm"] + counts["bcsr_panels_spmm"] > 0,
          "serve_obs: the warm-up launched no LOOPS kernel")
    for k, v in counts.items():
        launches[k] += v
        if k == "flash_attention":
            check(v == layers * (runs + slots), f"serve_obs: B5 launched "
                  f"{v} times for {runs} prefill calls and {slots} slots")
        elif k in ("csr_panels_spmm", "bcsr_panels_spmm"):
            part = k.split("_")[0]
            check(v == warm_disp[part], f"serve_obs: {k} launched {v} "
                  f"times, the warm-ups dispatched {warm_disp[part]}")
        else:
            check(v == 0, f"serve_obs: {k} launched {v} times off its path")
    # B1/B2 at this path's plan and N against the plain version (after the
    # counts are read: a comparison is no launch of the path)
    pool_check = _pool_plan_check(csr0, rec0)
    del csr0, w0
    rec = {"phase": "serve_obs", "arch": LM_ARCH, "requests": LM_BATCH,
           "prompt_len": LM_PROMPT, "gen_len": OBS_GEN, "layers": layers,
           "run_s": run_s, "warm_s": sum(r["dur"] for r in warm_spans) / 1e6,
           "warm_layer_s": [r["dur"] / 1e6 for r in warm_spans],
           "warm_lookups": warm, "pool_installed": installed,
           "pool_plans": pool_plans, "pool_plan_check": pool_check,
           "warm_dispatches": warm_disp,
           "rewarm_s": rewarm_s, "rewarm_lookups": re_stats,
           "histogram_counts": hists, "launches": counts,
           "with_obs": {k: v for k, v in served_obs.items() if k != "tokens"},
           "without_obs": {k: v for k, v in served_plain.items()
                           if k != "tokens"},
           "with_fault": {k: v for k, v in served_fault.items()
                          if k != "tokens"},
           "fault_plan": OBS_FAULT_PLAN, "retries": retries,
           "serve_lm": {k: lm_rec[k] for k in (
               "prefill_ms", "ttft_ms", "tokens_per_s", "decode_ms_median",
               "gen_len")},
           "nvidia_smi": RECORD["phases"][0].get("nvidia_smi"),
           "pool_slots_built": slots, "tokens_equal": True}
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 10: the closed-loop serving load (batched against sequential)
# ---------------------------------------------------------------------------

TRAFFIC_KEYS = ("n_requests", "completed", "rejected", "evicted",
                "prefill_batches", "decode_steps", "engine_calls",
                "padded_slots", "tokens", "goodput_tok_s", "p50_ms",
                "p99_ms", "ttft_p50_ms", "ttft_p99_ms", "wall_s")


def phase_serve_traffic(launches: dict) -> dict:
    """``repro_torch.benchmarks.serve_traffic.main`` at phase serve_lm's
    model (full width, bf16), the reference's shapes and load (6 clients x
    3 rounds), both modes, two passes each through one pool; then two
    requests of one bucket in flight at once (max_batch 1, max_in_flight
    2), which must take two slots and emit what each emits alone."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import serve_traffic
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.queue import ExecutorPool, ServeQueue
    from repro_torch.serve.scheduler import SchedulerConfig

    cfg = get_config(LM_ARCH)
    layers = cfg.num_layers
    records, lines = [], []
    _reset_counts()
    t0 = time.perf_counter()
    res = serve_traffic.main(out=lines.append, record=records.append,
                             arch=LM_ARCH, reduced=False, device=DEVICE)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = _read_counts()
    b, s = res["batched"], res["sequential"]
    for mode, r in (("batched", b), ("sequential", s)):
        check(r["completed"] == r["n_requests"] and not r["rejected"],
              f"serve_traffic {mode}: {r['completed']} of {r['n_requests']} "
              f"requests completed, {r['rejected']} rejected")
    check(b["engine_calls"] <= s["engine_calls"], f"serve_traffic: batched "
          f"{b['engine_calls']} engine calls > sequential {s['engine_calls']}")
    # two passes a mode, the same schedule each (a pure function of the
    # seed); one eager prefill per slot before its captures
    prefills = 2 * (b["prefill_batches"] + s["prefill_batches"])
    slots = res["pool"]["slots"]
    for k, v in counts.items():
        launches[k] += v
        want = layers * (prefills + slots) if k == "flash_attention" else 0
        check(v == want, f"serve_traffic: {k} launched {v} times for "
              f"{prefills} prefill calls and {slots} slots")

    # Two groups of one bucket in flight at once.
    params = api.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(LM_SEED),
        device=DEVICE)
    rng = np.random.default_rng(LM_SEED + 2)
    prompts = rng.integers(0, cfg.vocab_size, (2, 32)).tolist()
    pool = ExecutorPool(cfg, params)

    def drive(in_flight, rows):
        q = ServeQueue(cfg, params, pool=pool, config=SchedulerConfig(
            max_in_flight=in_flight, max_batch=1, min_batch=1,
            max_wait_s=0.0))
        reqs = [q.submit(p, 8, now=0.0) for p in rows]
        t = 0.0
        while q.pending and q.step(now=t):
            t += 1.0
        return [r.tokens for r in reqs]
    both = drive(2, prompts)
    check(pool.slots == 2 and pool.peak_in_use == 2 and len(pool) == 1,
          f"serve_traffic: two groups of one bucket took {pool.slots} slots "
          f"of {len(pool)} buckets (peak {pool.peak_in_use} at once)")
    alone = [drive(1, [p])[0] for p in prompts]
    check(alone == both and all(len(t) == 8 for t in both),
          "serve_traffic: two groups in flight emitted other tokens than "
          "each alone")
    del params, pool
    torch.cuda.empty_cache()
    rec = {"phase": "serve_traffic", "arch": LM_ARCH, "dtype": "bfloat16",
           "shapes": serve_traffic.SHAPES, "clients": 6, "rounds": 3,
           "main_s": main_s, "lines": lines,
           "modes": {m: {k: res[m][k] for k in TRAFFIC_KEYS}
                     for m in ("batched", "sequential")},
           "pool": res["pool"], "launches": counts,
           "prefill_calls": prefills,
           "batched_peak_in_use": res["pool"]["peak_in_use"],
           "two_slot_run": {"slots": 2, "peak_in_use": 2,
                            "tokens_equal_alone": True},
           "nvidia_smi": RECORD["phases"][0].get("nvidia_smi")}
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 11: the paper's operator evaluation
# ---------------------------------------------------------------------------

def _bench_run(out_dir) -> dict:
    """``python -m repro_torch.benchmarks.run --smoke`` on the card, in a
    process of its own (its serve_traffic suite runs B5, which is not on
    this phase's path, so its launches stay out of this process's counts),
    with a fresh plan cache; its records validated against the port's
    schema and gated against the committed CPU baseline with the wall
    columns off, so the exact columns are equal on the card and on the
    CPU."""
    import os
    from repro_torch.benchmarks import perf_gate
    from repro_torch.perf import schema
    env = {k: v for k, v in os.environ.items() if k != "REPRO_TUNE_CACHE"}
    env["PYTHONPATH"] = str(ROOT / "src")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--smoke",
         "--out", str(out_dir)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    run_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"benchmarks.run --smoke exited "
          f"{proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    current = pathlib.Path(out_dir) / "bench.json"
    records = json.loads(current.read_text())
    probs = schema.validate(records, {"$ref": "#/definitions/bench_file"},
                            schema.load_schema(perf_gate.SCHEMA_PATH))
    check(not probs, f"benchmarks.run --smoke records: {probs[:3]}")
    fails = perf_gate.run_gate(perf_gate.DEFAULT_BASELINE, current,
                               wall_tol=float("inf"))
    check(not fails, f"perf_gate against the CPU baseline: {fails[:3]}")
    return {"s": run_s, "records": len(records),
            "baseline": str(perf_gate.DEFAULT_BASELINE.relative_to(ROOT)),
            "gate": "OK (wall columns off)",
            "lines": [ln for ln in proc.stdout.splitlines()
                      if ln.count(",") >= 2]}


def _fig4_published(lines) -> list:
    """Fig. 4 at the published sizes (``fig4_throughput.published_rows``),
    N = 32, fp32 and ``FIG4_DTYPES``: the deterministic plan, each
    ``loops_spmm`` checked against the flat path and timed beside it,
    cuSPARSE and dense cuBLAS (or None with its reason)."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import fig4_throughput as f4
    from repro_torch.benchmarks._util import time_fn
    from repro_torch.core import loops_spmm, suite
    out = []
    for mid in f4.MATRICES:
        rows, cut = f4.published_rows(mid)
        t0 = time.perf_counter()
        base = suite.table2_like(mid, scale_rows=rows, seed=3,
                                 dtype=np.float64)
        gen_s = time.perf_counter() - t0
        for dname in FIG4_DTYPES:
            dt = getattr(torch, dname)
            csr = base if dname == "float64" else base.astype(np.float32)
            gen = torch.Generator(device=DEVICE).manual_seed(3)
            b = torch.randn((csr.shape[1], f4.N), generator=gen,
                            device=DEVICE, dtype=dt)
            t0 = time.perf_counter()
            fmt, plan = f4.calibrated_plan(csr, b, deterministic=True)
            torch.cuda.synchronize()
            plan_s = time.perf_counter() - t0
            name_dt = {"float32": "fp32", "float64": "fp64"}[dname]
            res = f4.measure(csr, fmt, b, name_dt=name_dt)
            cell = {"matrix": mid, "name": suite.TABLE2_STATS[mid].name,
                    "rows": rows, "reduced": cut, "nnz": csr.nnz,
                    "dtype": dname, "r_boundary": plan.r_boundary,
                    "br": plan.br, "panel_g": plan.panel_g,
                    "generate_s": gen_s, "plan_s": plan_s, **res}
            if (mid, dname) == FIG4_CALIBRATED:
                # The calibrated plan once: its probes re-convert A.
                t0 = time.perf_counter()
                fmt_c, plan_c = f4.calibrated_plan(csr, b)
                torch.cuda.synchronize()
                cell["calibrated"] = {
                    "plan_s": time.perf_counter() - t0,
                    "r_boundary": plan_c.r_boundary,
                    "us_per_call": 1e6 * time_fn(
                        lambda: loops_spmm(fmt_c, b, device=DEVICE),
                        device=DEVICE)}
                del fmt_c
            lines.append(f"fig4 {mid} {dname}: {res['us_per_call']:.1f} us, "
                         f"cuSPARSE {res['cusparse_us']:.1f} us")
            out.append(cell)
            del fmt, b
            torch.cuda.empty_cache()
    return out


def phase_operator_bench(launches: dict, out_dir) -> dict:
    """The paper's operator evaluation on the card: the smoke run and its
    gate (``_bench_run``), Fig. 4 at the published sizes, the batched
    suite at pwtk's size (each strategy's launches in one call), Table 4
    with ogbn-arxiv's row, §4.3 at ``SEC43_ROWS`` rows and the autotune
    suite.  Only B1 and B2 may launch in it."""
    import os
    import numpy as np
    import torch
    from repro_torch.benchmarks import (autotune_suite, batched_spmm,
                                        sec43_scheduling, table4_gnn)
    from repro_torch.core import suite

    os.environ.pop("REPRO_TUNE_CACHE", None)   # the suite's own temp cache
    rec = {"phase": "operator_bench", "seconds": {}}
    secs = rec["seconds"]
    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        rec["smoke"] = _bench_run(pathlib.Path(out_dir or tmp) / "bench")
    secs["smoke"] = rec["smoke"]["s"]

    _reset_counts()
    lines = []
    t0 = time.perf_counter()
    rec["fig4"] = _fig4_published(lines)
    secs["fig4"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    m6 = suite.table2_like("m6", scale_rows=200_000, seed=3)
    fmt, fmt_piped = batched_spmm.formats(m6, DEVICE)
    batched = batched_spmm.run_matrix(
        fmt, fmt_piped, BATCHED_BATCHES, rng=np.random.default_rng(0),
        out=lines.append, device=DEVICE)
    # Each strategy's launches in one call, forward and forward+backward
    # (dB on Aᵀ, built by the suite's first backward).
    tl = fmt.transposed()
    validated(fmt, "operator_bench batched m6")
    validated(tl.fmt, "operator_bench batched m6 transposed")
    fwd_parts = {"csr_panels_spmm": int(fmt.r_boundary > 0),
                 "bcsr_panels_spmm": int(fmt.r_boundary < fmt.nrows)}
    bwd_parts = {k: v + int(tl.fmt.r_boundary > 0 if k.startswith("csr")
                            else tl.fmt.r_boundary < tl.fmt.nrows)
                 for k, v in fwd_parts.items()}
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    per_call = {}
    for batch in BATCHED_BATCHES:
        b3 = torch.randn((batch, m6.shape[1], batched_spmm.N),
                         generator=gen, device=DEVICE)
        for name, fns in batched_spmm.strategies(fmt, batch,
                                                 DEVICE).items():
            calls = batch if name in ("loop", "vmap") else 1
            for fn, parts, what in zip(fns, (fwd_parts, bwd_parts),
                                       ("fwd", "fwdbwd")):
                before = _read_counts()
                fn(b3)
                torch.cuda.synchronize()
                after = _read_counts()
                n = {k: after[k] - before[k] for k in after}
                per_call[f"b{batch}_{name}_{what}"] = n
                for k, v in n.items():
                    want = parts.get(k, 0) * calls
                    check(v == want, f"batched b{batch} {name} {what}: {k} "
                          f"launched {v} times in one call (expected "
                          f"{want})")
        del b3
    rec["batched"] = {"rows": m6.nrows, "nnz": m6.nnz,
                      "r_boundary": fmt.r_boundary, "records": batched,
                      "launches_per_call": per_call}
    del fmt, m6
    torch.cuda.empty_cache()
    secs["batched"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rec["table4"] = table4_gnn.main(
        out=lines.append, device=DEVICE,
        graphs=table4_gnn.GRAPHS + [table4_gnn.ARXIV])
    secs["table4"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rec["sec43"] = sec43_scheduling.main(out=lines.append, rows=SEC43_ROWS,
                                         device=DEVICE)
    secs["sec43"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    auto = autotune_suite.main(out=lines.append, device=DEVICE)
    rec["autotune"] = {"cache": auto["cache"], "plans": {
        mid: {"model": plan_dict(p["model"]), "tuned": plan_dict(p["tuned"]),
              "gflops_model": p["gflops_model"],
              "gflops_tuned": p["gflops_tuned"]}
        for mid, p in auto["plans"].items()}}
    secs["autotune"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = _read_counts()
    for k, v in counts.items():
        launches[k] += v
        on_path = k in ("csr_panels_spmm", "bcsr_panels_spmm")
        check(v > 0 if on_path else v == 0, f"operator_bench: {k} "
              f"launched {v} times (only B1 and B2 are on this path)")
    rec.update(launches=counts, lines=lines,
               nvidia_smi=RECORD["phases"][0].get("nvidia_smi"))
    phase(rec)
    return rec

# ---------------------------------------------------------------------------
# phase 12: LM training
# ---------------------------------------------------------------------------

def grad_row_err(got, want) -> float:
    """max over rows of |got - want| / max(|want|, 1e-3 max|want|), the
    norms over the last dimension, in float64: :func:`row_err` with a
    floor, since some gradient rows are zero in exact arithmetic (dQ of the
    first causal row, whose one key makes P = 1 and dS = 0) and hold only
    rounding."""
    w = want.double()
    norms = w.norm(dim=-1)
    floor = max(float(norms.max()) * 1e-3, 1e-300)
    d = (got.double() - w).norm(dim=-1)
    return float((d / norms.clamp_min(floor)).max())


def flash_bwd_bound(q, k) -> dict:
    """Least time of one B5 backward: Q, K, V, dO and the lse read once,
    dQ, dK, dV written once; the five products (QKᵀ recomputed, dV, dP,
    dQ, dK) over the (query, key) pairs the causal mask keeps, at the
    dtype's peak."""
    bsz, seq, heads, hd = q.shape
    pairs = seq * (seq + 1) / 2
    flops = 10.0 * hd * pairs * bsz * heads
    nbytes = ((4 * q.numel() + 4 * k.numel()) * q.element_size()
              + 4 * bsz * heads * seq)
    return bound(bytes_moved=float(nbytes), flops=flops,
                 dtype=str(q.dtype).replace("torch.", ""))


def _b5_train(dt) -> dict:
    """B5 in training at llama3.2-1b's layer shape, causal: the kernel's
    log-sum-exp against the plain version's (``LSE_TOL`` of max(1, |lse|)),
    the Function's dQ, dK, dV against autograd through the plain forward
    run in fp32 on the same inputs (each row within ``FLASH_ROW_TOL`` of
    its norm, :func:`grad_row_err`), and the times of the forward (with
    the lse, and with a null lse as served), the backward alone and both,
    against ``scaled_dot_product_attention``'s forward and backward (the
    yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as b5
    dname = str(dt).replace("torch.", "")
    _, _, heads, kv, hd = FLASH_SHAPES[-1]
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    q, k, v = (torch.randn((LM_BATCH, LM_PROMPT, n, hd), generator=gen,
                           device=DEVICE).to(dt) for n in (heads, kv, kv))
    do = torch.randn(q.shape, generator=gen, device=DEVICE).to(dt)
    out, lse = b5.flash_attention(q, k, v, causal=True, return_lse=True)
    out_p, lse_p = b5.flash_attention_plain(q, k, v, causal=True,
                                            return_lse=True)
    null = b5.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    lse_err, lse_scale = max_err(lse, lse_p)
    check(lse_err <= LSE_TOL * lse_scale, f"B5 lse {dname}: err "
          f"{lse_err:.3g} > {LSE_TOL:g} * {lse_scale:.3g}")
    check(torch.equal(out, null), f"B5 {dname}: the output with an lse "
          "differs from the output without")
    del out_p, lse_p, null
    ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
    y = b5.flash_attention_train(*ins, causal=True)
    grads = torch.autograd.grad(y, ins, do, retain_graph=True)
    ref_in = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    ref_g = torch.autograd.grad(
        b5.flash_attention_plain(*ref_in, causal=True), ref_in, do.float())
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), grads, ref_g):
        check(g.dtype == dt and g.shape == w.shape, f"B5 {name} {dname}: "
              f"{g.dtype} {tuple(g.shape)}")
        errs[name] = grad_row_err(g, w)
        check(errs[name] <= FLASH_ROW_TOL[dname], f"B5 {name} {dname}: row "
              f"err {errs[name]:.3g} > {FLASH_ROW_TOL[dname]:g}")
    del ref_in, ref_g
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    sd = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot = do.transpose(1, 2)
    rec = {"dtype": dname, "shape": list(q.shape), "kv_heads": kv,
           "causal": True, "lse_max_abs_err": lse_err,
           "grad_row_err": errs,
           "fwd_ms": time_ms(lambda: b5.flash_attention(
               q, k, v, causal=True, return_lse=True)),
           "fwd_null_lse_ms": time_ms(lambda: b5.flash_attention(
               q, k, v, causal=True)),
           "bwd_ms": time_ms(lambda: torch.autograd.grad(
               y, ins, do, retain_graph=True), samples=5, reps=2),
           "fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
               b5.flash_attention_train(*ins, causal=True), ins, do),
               samples=5, reps=2),
           "library_fwd_ms": time_ms(lambda: F.scaled_dot_product_attention(
               qt.detach(), kt.detach(), vt.detach(), is_causal=True,
               enable_gqa=True)),
           "library_bwd_ms": time_ms(lambda: torch.autograd.grad(
               sd, (qt, kt, vt), dot, retain_graph=True)),
           "library": "torch.nn.functional.scaled_dot_product_attention("
                      "is_causal=True, enable_gqa=True), its autograd "
                      "backward",
           "bwd_bound": flash_bwd_bound(q, k)}
    rec["bwd_over_library"] = rec["bwd_ms"] / rec["library_bwd_ms"]
    del q, k, v, do, out, lse, ins, y, grads, qt, kt, vt, sd
    torch.cuda.empty_cache()
    return rec


def _train_cli(argv) -> dict:
    """``repro_torch.launch.train.main(argv)`` with the kernels' counts
    set to 0 just before and read just after, and the peak memory."""
    import torch
    from repro_torch.launch import train as train_cli
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    rec = train_cli.main(argv)
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = _read_counts()
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return rec


def _release() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _check_lm_launches(what: str, counts: dict, b5_want: int,
                       launches: dict, wkv6_want: int = 0,
                       wkv6_bwd_want: int = 0) -> None:
    for k, v in counts.items():
        launches[k] += v
        want = {"flash_attention": b5_want, "wkv6": wkv6_want,
                "wkv6_bwd": wkv6_bwd_want}.get(k, 0)
        check(v == want, f"{what}: {k} launched {v} times (expected {want})")


def _plain_train_loss(cfg, params, mb):
    """The step-0 check's reference: ``train_loss`` with attention's plain
    version (``backend="torch"``, differentiated by autograd) and the
    cross-entropy over the whole fp32 ``(T, vocab)`` logits, also
    differentiated by autograd, so it shares neither B5's backward
    (``flash_attention_bwd``) nor ``_ChunkedCE``'s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    tokens, labels = mb["tokens"].long(), mb["labels"].long()
    x = tf._embed_inputs(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = tf._run_stack(cfg, params, x, positions, backend="torch")
    x = layers.norm_apply(cfg.norm, params.final_norm, x)
    logits = (x.reshape(-1, x.shape[-1]).float()
              @ tf._unembed_w(cfg, params).float().T)
    return F.cross_entropy(logits, labels.reshape(-1), ignore_index=-1)


def _lse_without_tile(q, k, lse, tile: int):
    """Planted fault: each row's log-sum-exp with the causal keys of the
    64-key tile ``tile`` left out (rows that see none of them keep it)."""
    import math

    import torch
    bsz, seq, heads, hd = q.shape
    k0, k1 = 64 * tile, 64 * (tile + 1)
    kt = k[:, k0:k1].float().repeat_interleave(heads // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kt) / math.sqrt(hd)
    qpos = torch.arange(seq, device=q.device)[:, None]
    kpos = torch.arange(k0, k1, device=q.device)[None, :]
    part = torch.logsumexp(s.masked_fill(kpos > qpos, float("-inf")), -1)
    share = torch.exp(part - lse).clamp(max=1.0 - 1e-6)
    return lse + torch.log1p(-share)


def _planted_bwd(fault: str, real):
    """``flash_attention_bwd`` with a planted fault: ``"lse_tile"`` reads
    an lse that left K/V tile 1 out; ``"bwd_tile"`` leaves tile 1 out of
    dK and dV."""
    def bwd(q, k, v, lse, dout, *, causal, **kw):
        if fault == "lse_tile":
            lse = _lse_without_tile(q, k, lse, 1)
        dq, dk, dv = real(q, k, v, lse, dout, causal=causal, **kw)
        if fault == "bwd_tile":
            dk[:, 64:128] = 0
            dv[:, 64:128] = 0
        return dq, dk, dv
    return bwd


def _step0_errors(names, loss, grads, ref_loss, ref_grads) -> dict:
    """The loss's relative difference, the global gradient norm's, and
    each leaf's ``|g - g_ref| / |g_ref|`` (Frobenius norms, float64)."""
    leaf = {}
    sq = sq_ref = 0.0
    for name, g, w in zip(names, grads, ref_grads):
        gd, wd = g.double(), w.double()
        n_ref = float(wd.norm())
        sq += float(gd.norm()) ** 2
        sq_ref += n_ref ** 2
        leaf[name] = float((gd - wd).norm()) / max(n_ref, 1e-300)
    worst = max(leaf, key=leaf.get)
    return {"loss": loss, "loss_ref": ref_loss,
            "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
            "grad_norm": sq ** 0.5, "grad_norm_ref": sq_ref ** 0.5,
            "grad_norm_rel": abs(sq ** 0.5 - sq_ref ** 0.5) / sq_ref ** 0.5,
            "leaf_max": leaf[worst], "leaf_worst": worst, "leaf": leaf}


def _step0_violations(e: dict) -> list:
    out = []
    for key, tol in (("loss_rel", TRAIN_LOSS_TOL),
                     ("grad_norm_rel", TRAIN_GNORM_TOL),
                     ("leaf_max", TRAIN_LEAF_TOL)):
        if not e[key] <= tol:
            out.append(f"{key} {e[key]:.3g} > {tol:g}")
    return out


def _train_step0_check(cfg, params, mb, launches: dict) -> dict:
    """Step 0's first microbatch at full width, grad on: ``train_loss``'s
    loss and every gradient leaf through B5's Function (its forward, the
    remat recompute, ``flash_attention_bwd``) and ``_ChunkedCE`` against
    :func:`_plain_train_loss` on the same weights and microbatch, within
    ``TRAIN_LOSS_TOL``, ``TRAIN_GNORM_TOL`` and ``TRAIN_LEAF_TOL``; then
    the same run with each planted fault of :func:`_planted_bwd`, which
    must break one of those limits."""
    import torch
    from repro_torch.kernels import flash_attention as b5
    from repro_torch.models import api
    names = [n for n, _ in params.named_parameters()]
    plist = [p for _, p in params.named_parameters()]

    def grads_of(loss_fn):
        loss = loss_fn()
        grads = torch.autograd.grad(loss, plist)
        return float(loss.detach()), grads

    _reset_counts()
    t0 = time.perf_counter()
    ref_loss, ref_g = grads_of(lambda: _plain_train_loss(cfg, params, mb))
    ref_s = time.perf_counter() - t0
    _check_lm_launches("train_lm step-0 reference", _read_counts(), 0,
                       launches)
    loss, g = grads_of(lambda: api.train_loss(cfg, params, mb)[0])
    _check_lm_launches("train_lm step-0 gradients", _read_counts(),
                       2 * cfg.num_layers, launches)
    errs = _step0_errors(names, loss, g, ref_loss, ref_g)
    del g
    bad = _step0_violations(errs)
    check(not bad, f"train_lm step 0 through B5 against the plain "
          f"reference: {bad} (worst leaf {errs['leaf_worst']})")
    keep = [n for n in names if n == "embed" or n.startswith(
        ("layers.0.", f"layers.{cfg.num_layers - 1}."))]
    rec = {"loss_b5": loss, "ref_s": ref_s,
           "b5": {**{k: v for k, v in errs.items() if k != "leaf"},
                  "leaf": {n: errs["leaf"][n] for n in keep}},
           "planted": {}}
    real = b5.flash_attention_bwd
    for fault in ("lse_tile", "bwd_tile"):
        b5.flash_attention_bwd = _planted_bwd(fault, real)
        try:
            _reset_counts()
            f_loss, f_g = grads_of(lambda: api.train_loss(cfg, params,
                                                          mb)[0])
        finally:
            b5.flash_attention_bwd = real
        fe = _step0_errors(names, f_loss, f_g, ref_loss, ref_g)
        del f_g
        fbad = _step0_violations(fe)
        check(bool(fbad), f"train_lm step 0: planted fault {fault} passes "
              f"the limits (leaf_max {fe['leaf_max']:.3g}, grad_norm_rel "
              f"{fe['grad_norm_rel']:.3g})")
        rec["planted"][fault] = {
            "loss_rel": fe["loss_rel"], "grad_norm_rel": fe["grad_norm_rel"],
            "leaf_max": fe["leaf_max"], "leaf_worst": fe["leaf_worst"],
            "violations": fbad}
    del ref_g
    _release()
    return rec


def _train_full_width(launches: dict, rec: dict) -> None:
    """The launcher at llama3.2-1b's full width, bf16: run A trains 4
    steps with a checkpoint after step 2; run B resumes from that
    checkpoint, in a fresh model, for steps 3-4 (neither writes a final
    checkpoint: the one after step 2 is the save path's test, and the 17.3
    GB writes at the end cost ~20 s); then step 0 on the same
    weights and batch (:func:`_train_step0_check`) and one profiled
    step."""
    import os
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, global_batch_at
    from repro_torch.dist.step import default_microbatches
    from repro_torch.models import api

    base = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(base, ignore_errors=True)
    dir_a, dir_b = base / "a", base / "b"
    argv = ["--arch", LM_ARCH, "--device", DEVICE, "--seq-len",
            str(TRAIN_SEQ), "--global-batch", str(TRAIN_BATCH), "--steps",
            str(TRAIN_STEPS), "--log-every", "1", "--seed", str(LM_SEED),
            "--no-final-ckpt"]
    n_mb = default_microbatches(ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH,
                                            "train"))
    cfg = get_config(LM_ARCH)
    per_step = cfg.num_layers * 2 * n_mb     # forward and remat recompute
    try:
        run_a = _train_cli(argv + ["--ckpt-every", str(TRAIN_CKPT_AT),
                                   "--ckpt-dir", str(dir_a)])
        _release()
        _check_lm_launches("train_lm run A", run_a["launches"],
                           per_step * TRAIN_STEPS, launches)
        ckpt = f"ckpt_{TRAIN_CKPT_AT:010d}.tensors"
        os.makedirs(dir_b)
        os.link(dir_a / ckpt, dir_b / ckpt)
        shutil.rmtree(dir_a)     # the disk holds two full checkpoints
        run_b = _train_cli(argv + ["--resume", "--ckpt-dir", str(dir_b)])
        _release()
        _check_lm_launches("train_lm run B", run_b["launches"],
                           per_step * (TRAIN_STEPS - TRAIN_CKPT_AT),
                           launches)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    check(run_b["start_step"] == TRAIN_CKPT_AT,
          f"train_lm: resumed at {run_b['start_step']}")
    steps_a = run_a["steps"]
    for s in steps_a + run_b["steps"]:
        check(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]),
              f"train_lm: step {s['step']} loss {s['loss']} grad_norm "
              f"{s['grad_norm']}")
    same = [(a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
            for a, b in zip(steps_a[TRAIN_CKPT_AT:], run_b["steps"])]
    check(len(same) == TRAIN_STEPS - TRAIN_CKPT_AT and all(same),
          f"train_lm: resumed steps {run_b['steps']} differ from the "
          f"uninterrupted run's {steps_a[TRAIN_CKPT_AT:]}")
    for r in (run_a, run_b):
        check(r["peak_mem_gb"] < 80, f"train_lm: peak {r['peak_mem_gb']:.1f}"
              " GB")

    # Step 0 on the same weights and batch: the first microbatch's loss
    # and gradients through B5 against the plain reference (and against
    # two planted faults, which must fail the same limits), the second's
    # loss, and the mean of both against run A's step-0 loss.
    params = api.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        LM_SEED), device=DEVICE)
    batch = global_batch_at(DataConfig(seed=LM_SEED), cfg, ShapeConfig(
        "t", TRAIN_SEQ, TRAIN_BATCH, "train"), n_mb, 0, device=DEVICE)
    mbs = [{k: v[i] for k, v in batch.items()} for i in range(n_mb)]
    step0 = _train_step0_check(cfg, params, mbs[0], launches)
    _reset_counts()
    with torch.no_grad():
        kernel = [step0["loss_b5"]] + [float(api.train_loss(cfg, params,
                                                            mb)[0])
                                       for mb in mbs[1:]]
    _check_lm_launches("train_lm step-0 losses", _read_counts(),
                       cfg.num_layers * (n_mb - 1), launches)
    # One train step of the same model and batch under the profiler (after
    # one unprofiled): its kernels by device time and the idle share.
    from repro_torch.dist.step import build_train_step
    from repro_torch.optim import OptConfig, init_opt_state
    train_step = build_train_step(cfg, params, OptConfig(
        lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS),
        n_microbatches=n_mb)
    state = init_opt_state(params, 1)
    _reset_counts()
    train_step(params, state, batch)
    profiled = profile_step(lambda: train_step(params, state, batch))
    _check_lm_launches("train_lm profiled steps", _read_counts(),
                       2 * per_step, launches)
    del params, batch, mbs, train_step, state
    _release()
    cli0 = steps_a[0]["loss"]
    mean0 = sum(kernel) / n_mb
    check(abs(mean0 - cli0) <= 1e-5 * abs(cli0), f"train_lm: step-0 loss "
          f"{cli0} in the run vs {mean0} recomputed")

    step_ms = [s["step_s"] * 1e3 for s in steps_a[1:]]
    med_s = statistics.median(step_ms) / 1e3
    n_params = run_a["params"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = (6.0 * n_params + 12.0 * cfg.num_layers * TRAIN_SEQ
             * cfg.d_model) * tokens
    rec["full_width"] = {
        "arch": LM_ARCH, "dtype": str(cfg.dtype), "seq_len": TRAIN_SEQ,
        "global_batch": TRAIN_BATCH, "n_microbatches": n_mb,
        "params": n_params, "steps": steps_a, "resumed_steps":
        run_b["steps"], "resumed_equal_bitwise": all(same),
        "step0": step0, "step_ms_steps_2_to_4": step_ms,
        "median_step_ms": med_s * 1e3, "tokens_per_s": tokens / med_s,
        "peak_mem_gb": [run_a["peak_mem_gb"], run_b["peak_mem_gb"]],
        "ckpt_saves": run_a["ckpt"] + run_b["ckpt"],
        "restore_s": run_b["restore_s"],
        "run_s": [run_a["wall_s"], run_b["wall_s"]],
        "launches_per_step": {"flash_attention": per_step},
        "profiled_step": profiled,
        "model_flops_share": flops / (med_s * PEAK_FLOPS["bfloat16"]),
        "model_flops_share_formula":
            "(6 * params + 12 * layers * seq_len * d_model) * tokens / "
            "(median step s * 989e12)"}


def _train_reduced(launches: dict) -> dict:
    """30 steps of the reduced llama on the card (seq 32, batch 4, two
    microbatches, lr 1e-2, two alternating batches), as the reference's
    ``test_loss_decreases``: the loss falls by more than 0.5."""
    import numpy as np
    import torch
    from repro_torch.configs import REDUCED
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, global_batch_at
    from repro_torch.dist.step import build_train_step
    from repro_torch.models import api
    from repro_torch.optim import OptConfig, init_opt_state
    cfg = REDUCED[LM_ARCH]()
    params = api.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        0), device=DEVICE)
    train_step = build_train_step(cfg, params, OptConfig(
        lr=1e-2, warmup_steps=2, total_steps=50), n_microbatches=2)
    state = init_opt_state(params, 1)
    shape = ShapeConfig("t", 32, 4, "train")
    batches = [global_batch_at(DataConfig(seed=7), cfg, shape, 2, s,
                               device=DEVICE) for s in (0, 1)]
    _reset_counts()
    losses = []
    t0 = time.perf_counter()
    for step in range(REDUCED_STEPS):
        params, state, m = train_step(params, state, batches[step % 2])
        losses.append(float(m["loss"]))
    wall = time.perf_counter() - t0
    _check_lm_launches("train_lm reduced", _read_counts(),
                       cfg.num_layers * 2 * 2 * REDUCED_STEPS, launches)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.5,
          f"train_lm reduced: losses {losses[::6]}")
    return {"config": cfg.name, "steps": REDUCED_STEPS, "losses": losses,
            "ms_per_step": wall / REDUCED_STEPS * 1e3}


def _example_module(name: str = "train_lm_torch"):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_defaults(ex, launches: dict) -> dict:
    """``examples/train_lm_torch.py`` at its defaults (the reference's):
    it learns, and its kernel logits equal the plain path's at 1e-3 (both
    asserted by the example)."""
    _reset_counts()
    t0 = time.perf_counter()
    rec = ex.main(["--device", DEVICE])
    rec["wall_s"] = time.perf_counter() - t0
    counts = _read_counts()
    for k, v in counts.items():
        launches[k] += v
    check(counts["flash_attention"] > 0
          and counts["csr_panels_spmm"] + counts["bcsr_panels_spmm"] > 0
          and counts["csr_sdd_panels"] + counts["bcsr_sdd_panels"] > 0,
          f"train_lm example: launches {counts}")
    return {"losses_first_last": [rec["losses"][0], rec["losses"][-1]],
            "median_step_ms": statistics.median(rec["step_s"]) * 1e3,
            "plan_s": rec["plan_s"], "transpose_s": rec["transpose_s"],
            "logits_max_abs_err": rec["logits_max_abs_err"],
            "n_params": rec["n_params"], "nnz": rec["nnz"],
            "launches": counts, "wall_s": rec["wall_s"]}


def _example_ffn_width(ex, launches: dict) -> dict:
    """The example's model at llama3.2-1b's FFN width (d 2048, d_ff 8192,
    32 heads, 90% sparsity, 2 layers, seq 512, batch 4), fp32: one step's
    value gradients of every sparse layer against the flat path on that
    layer's own input and output cotangent (each element within ``TOL``
    of its summation bound |dY|·|X|, as phase 7), then ``EX_STEPS`` SGD
    steps; B1-B5 must all launch."""
    import numpy as np
    import torch
    from repro_torch.models.sparse_ffn import sparse_linear_apply
    a = EX_FFN
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    params, structures = ex.build(a["d_model"], a["d_ff"], a["layers"],
                                  a["vocab"], a["sparsity"],
                                  np.random.default_rng(0), device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for pair in structures:
        for layer in pair:
            layer.fmt.transposed(dtype=torch.float32).fmt.on(dev)
    torch.cuda.synchronize()
    transpose_s = time.perf_counter() - t0
    _reset_counts()
    toks, tgt = ex.batch_at(0, a["batch"], a["seq"], a["vocab"], dev)
    taps = []
    loss = ex.loss_fn(params, structures, toks, tgt, a["heads"], taps=taps)
    loss.backward()       # fills the taps' retained output gradients too
    checks = []
    for i, (layer, x, y) in enumerate(taps):
        # a part with no values (no CSR rows) takes no gradient
        names = [n for n in ("csr_vals", "bcsr_vals")
                 if getattr(layer, n).numel()]
        vals = [getattr(layer, n) for n in names]
        dy = y.grad
        flat = torch.autograd.grad(sparse_linear_apply(
            layer, x.detach(), backend="torch"), vals, dy)
        bnd = torch.autograd.grad(sparse_linear_apply(
            layer, x.detach().abs(), backend="torch"), vals, dy.abs())
        for name, v, f, b in zip(names, vals, flat, bnd):
            checks.append({"layer": i, "part": name, "numel": v.numel(),
                           **_grad_check(f"train_lm ffn-width layer {i} "
                                         f"{name}", v.grad, f, b,
                                         TOL["float32"])})
        del flat, bnd
    del taps, loss
    for p in ex.leaves(params):
        p.grad = None
    step_ms, losses = [], []
    for s in range(EX_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, tgt = ex.batch_at(s, a["batch"], a["seq"], a["vocab"], dev)
        losses.append(float(ex.sgd_step(params, structures, toks, tgt,
                                        a["heads"], a["lr"])))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = _read_counts()
    for k, v in counts.items():
        launches[k] += v
        check(v == 0 if k in ("wkv6", "wkv6_bwd") else v > 0,
              f"train_lm ffn-width: {k} "
              f"launched {v} times ({counts})")
    check(all(np.isfinite(losses)), f"train_lm ffn-width: losses {losses}")
    rec = {"config": a, "plan_s": plan_s, "transpose_s": transpose_s,
           "value_grad_checks": checks, "losses": losses,
           "step_ms": step_ms, "launches": counts,
           "nnz": sum(p.numel() for n, v in params.items()
                      if n.startswith("ffn") for p in v.values())}
    del params, structures
    _release()
    return rec


def phase_train_lm(launches: dict) -> dict:
    """Phase 12: B5 in training alone, the training launcher at full
    width with a checkpoint and a resume, the reduced llama's loss
    falling, and the sparse-FFN LM example at its defaults and at
    llama3.2-1b's FFN width."""
    import torch
    rec = {"phase": "train_lm"}
    t0 = time.perf_counter()
    rec["b5_train"] = [_b5_train(torch.bfloat16), _b5_train(torch.float32)]
    rec["b5_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _train_full_width(launches, rec)
    rec["full_width_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["reduced"] = _train_reduced(launches)
    ex = _example_module()
    rec["example_defaults"] = _example_defaults(ex, launches)
    rec["example_ffn_width"] = _example_ffn_width(ex, launches)
    rec["examples_s"] = time.perf_counter() - t0
    rec["nvidia_smi"] = RECORD["phases"][0].get("nvidia_smi")
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 13: the opt-in fallback chain and validate_loops
# ---------------------------------------------------------------------------

def validated(fmt, what: str):
    """``fmt`` once ``validate_loops`` has passed on it; the names of the
    formats so checked go to phase 13's record."""
    from repro_torch.resilience import validate_loops
    validate_loops(fmt, what=what)
    VALIDATED.append(what)
    return fmt


def _counter(obs, name, **labels) -> float:
    return sum(inst.value for kind, inst in obs.metrics.instruments()
               if kind == "counter" and inst.name == name
               and all(inst.labels.get(k) == v for k, v in labels.items()))


def _fallback_case(part, site, call, bound, kernels, obs) -> dict:
    """One chain of phase 13.  A fault injected at the chain's first link
    ``site`` raises under the process's policy; then the kernel's result;
    then the same fault, once, with the chains opted in: one
    ``engine.fallback`` count, none of ``kernels`` launched, each element
    within the fp32 tolerance of its summation bound ``bound`` of the
    kernel's result; then, opted in, a fault during a CUDA graph capture
    raises and degrades nothing."""
    import torch
    from repro_torch.resilience import (FallbackPolicy, FaultPlan,
                                        InjectedFault, set_plan, set_policy)

    def launched(before):
        after = _read_counts()
        return {k: after[k] - before[k] for k in kernels}

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    rec = {"site": site}
    set_plan(FaultPlan.parse(f"{site}:raise:0:0"))
    before = _read_counts()
    try:
        call()
        raised = False
    except InjectedFault:
        raised = True
    torch.cuda.synchronize()
    check(raised and not any(launched(before).values()),
          f"fallback {part}: the default policy did not raise at {site}")
    set_plan(None)
    before = _read_counts()
    want = call()
    torch.cuda.synchronize()
    rec["kernel_launches"] = launched(before)
    check(all(rec["kernel_launches"].values()), f"fallback {part}: the "
          f"kernel call launched {rec['kernel_launches']}")
    prev = set_policy(FallbackPolicy())
    try:
        set_plan(FaultPlan.parse(f"{site}:raise:0:1"))
        c0 = _counter(obs, "engine.fallback", part=part)
        before = _read_counts()
        t0 = time.perf_counter()
        got = call()
        torch.cuda.synchronize()
        rec["degraded_s"] = time.perf_counter() - t0
        rec["degraded_launches"] = launched(before)
        rec["fallback_count"] = _counter(obs, "engine.fallback",
                                         part=part) - c0
        check(rec["fallback_count"] == 1
              and not any(rec["degraded_launches"].values()),
              f"fallback {part}: {rec['fallback_count']} engine.fallback "
              f"counts, launches {rec['degraded_launches']}")
        errs = [sum_err(g, w, bd) for g, w, bd in
                zip(as_tuple(got), as_tuple(want), as_tuple(bound))]
        rec["max_abs_err"] = max(e[0] for e in errs)
        rec["max_err_of_bound"] = max(e[1] for e in errs)
        check(rec["max_err_of_bound"] <= TOL["float32"],
              f"fallback {part}: degraded against the kernel's: "
              f"{rec['max_err_of_bound']:.3g} of the summation bound")
        del got, want
        # A capture that fails keeps raising: nothing degrades in a graph.
        set_plan(FaultPlan.parse(f"{site}:raise:0:0"))
        c0 = _counter(obs, "engine.fallback", part=part)
        graph = torch.cuda.CUDAGraph()
        err = None
        try:
            with torch.cuda.graph(graph):
                call()
        except Exception as e:        # noqa: BLE001 - inspected below
            err = e
        torch.cuda.synchronize()
        rec["capture_raised"] = repr(err)[:200]
        check(isinstance(err, InjectedFault)
              or isinstance(getattr(err, "__context__", None),
                            InjectedFault),
              f"fallback {part}: a capture with a fault at {site} did not "
              f"raise it ({err!r})")
        check(_counter(obs, "engine.fallback", part=part) == c0,
              f"fallback {part}: the chain degraded during a capture")
        del graph
    finally:
        set_plan(None)
        set_policy(prev)
    return rec


def phase_fallback(launches: dict) -> dict:
    """Phase 13: the engine's fallback chain on the card
    (:func:`_fallback_case`) at m6 for ``csr`` (B1 on the CSR part through
    ``engine.csr_spmm``) and ``fused`` (``loops_spmm``, B1 and B2), and
    for ``loops``/``sdd`` at the sparse FFN's value gradient (B3 and B4);
    ``validate_loops`` passes on every format the script built and raises
    on one with a planted bad ``tile_cols``.  The process's policy (off)
    is checked first and put back after."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import loops_spmm, plan_and_convert, suite
    from repro_torch.kernels import engine
    from repro_torch.models import sparse_linear_from_dense
    from repro_torch.obs import Obs, set_active
    from repro_torch.resilience import (SparseInputError, get_policy,
                                        validate_loops)

    rec = {"phase": "fallback"}
    check(not get_policy().enabled, "fallback: the process starts with the "
          "chains on")
    obs = Obs(source="chip_smoke_fallback")
    prev_obs = set_active(obs)
    _reset_counts()
    t0 = time.perf_counter()
    try:
        rows = next(r for m, r, _ in MAIN_MATRICES if m == "m6")
        csr = suite.table2_like("m6", scale_rows=rows, seed=0,
                                dtype=np.float32)
        fmt, _ = plan_and_convert(csr, device=DEVICE)
        validated(fmt, "fallback m6")
        check(0 < fmt.r_boundary < fmt.nrows, "fallback: m6's plan has "
              "no CSR part")
        gen = torch.Generator(device=DEVICE).manual_seed(13)
        b = torch.randn((csr.shape[1], MAIN_N), generator=gen,
                        device=DEVICE)
        dev = fmt.on(DEVICE)
        afmt = abs_format(fmt)
        abs_b = b.abs()
        rec["csr"] = _fallback_case(
            "csr", "engine.csr.spmm.cuda",
            lambda: engine.csr_spmm(fmt.csr_part, b, panels=dev.csr),
            engine.csr_spmm(afmt.csr_part, abs_b, backend="torch"),
            ("csr_panels_spmm",), obs)
        rec["fused"] = _fallback_case(
            "fused", "engine.fused.spmm.cuda",
            lambda: loops_spmm(fmt, b, device=DEVICE),
            loops_spmm(afmt, abs_b, device=DEVICE, backend="torch"),
            ("csr_panels_spmm", "bcsr_panels_spmm"), obs)
        rec["m6"] = {"rows": csr.nrows, "nnz": csr.nnz,
                     "r_boundary": fmt.r_boundary}
        del fmt, dev, afmt, b, abs_b, csr

        rng = np.random.default_rng(4)
        w = (rng.standard_normal((FFN_D_OUT, FFN_D_IN)) * 0.02).astype(
            np.float32)
        layer = sparse_linear_from_dense(torch.from_numpy(w), FFN_SPARSITY,
                                         device=DEVICE)
        ffn = validated(layer.fmt, "fallback ffn")
        x = torch.randn(FFN_X_SHAPE, generator=gen, device=DEVICE)
        bt = x.transpose(-1, -2).contiguous()
        dy = torch.randn(FFN_X_SHAPE[:-1] + (FFN_D_OUT,), generator=gen,
                         device=DEVICE).transpose(-1, -2).contiguous()
        check(0 < ffn.r_boundary < ffn.nrows, "fallback: the FFN's plan "
              "has no CSR part")
        rec["loops_sdd"] = _fallback_case(
            "loops", "engine.loops.sdd.cuda",
            lambda: engine.loops_sdd(ffn, dy, bt),
            engine.loops_sdd(ffn, dy.abs(), bt.abs(), backend="torch"),
            ("csr_sdd_panels", "bcsr_sdd_panels"), obs)
        rec["ffn"] = {"shape": [FFN_D_OUT, FFN_D_IN], "nnz": ffn.nnz,
                      "r_boundary": ffn.r_boundary,
                      "x_shape": list(FFN_X_SHAPE)}

        # validate_loops: a planted bad tile_cols raises
        bc = ffn.bcsr_part
        cols = bc.tile_cols.copy()
        cols[len(cols) // 2] = bc.shape[1]
        bad = dataclasses.replace(ffn, bcsr_part=dataclasses.replace(
            bc, tile_cols=cols))
        try:
            validate_loops(bad, what="planted")
            kind = None
        except SparseInputError as e:
            kind = e.kind
        check(kind == "out-of-range-index", f"fallback: validate_loops on "
              f"a planted bad tile_cols gave {kind}")
        rec["validate_loops"] = {"passed": list(VALIDATED),
                                 "planted_tile_cols": kind}
        del layer, ffn, bad, x, bt, dy
    finally:
        set_active(prev_obs)
    check(not get_policy().enabled, "fallback: the policy was not put back")
    torch.cuda.synchronize()
    counts = _read_counts()
    for k, v in counts.items():
        launches[k] += v
        check(v == 0 if k in ("flash_attention", "wkv6", "wkv6_bwd")
              else v > 0,
              f"fallback: {k} launched {v} times")
    rec.update(launches=counts, seconds=time.perf_counter() - t0)
    _release()
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 14: examples/gcn_train_torch.py
# ---------------------------------------------------------------------------

def phase_gcn_example(launches: dict, work_dir) -> dict:
    """Phase 14: ``examples/gcn_train_torch.py``'s ``main`` at its
    defaults (the reference's: 2048 nodes, degree 8, 300 steps, lr 5.0)
    and once with ``--autotune`` (a fresh plan cache): its 1e-4 gradient
    check and its loss-decrease check (both raise in the example), the
    first and last loss and ms a step; B1 and B2 only."""
    import os
    rec = {"phase": "gcn_example"}
    ex = _example_module("gcn_train_torch")
    os.environ["REPRO_TUNE_CACHE"] = str(pathlib.Path(work_dir) / "gcn_tune")
    runs = {}
    for name, argv in (("defaults", []), ("autotune", ["--autotune"])):
        _reset_counts()
        t0 = time.perf_counter()
        res = ex.main(argv + ["--device", DEVICE])
        res["wall_s"] = time.perf_counter() - t0
        counts = _read_counts()
        for k, v in counts.items():
            launches[k] += v
            on_path = k in ("csr_panels_spmm", "bcsr_panels_spmm")
            check(v > 0 if on_path else v == 0, f"gcn_example {name}: {k} "
                  f"launched {v} times")
        check(res["grad_err"] <= 1e-4 and res["steps"] >= 40
              and res["last_loss"] < 0.7 * res["first_loss"],
              f"gcn_example {name}: {res}")
        res["launches"] = counts
        runs[name] = res
    check(runs["autotune"]["cache"]["misses"] == 1
          and runs["autotune"]["cache"]["hits"] == 1,
          f"gcn_example: the second layer did not hit the first's plan "
          f"({runs['autotune']['cache']})")
    rec.update(runs)
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 15: Table 3's energy, measured
# ---------------------------------------------------------------------------

def phase_table3(launches: dict) -> dict:
    """Phase 15: ``repro_torch.benchmarks.table3_energy`` on the card: for
    Table 3's six matrices at Table 2's sizes, fp16, N = 32, a loop of at
    least 2 s of ``loops_spmm`` and of cuSPARSE between readings of NVML's
    energy counter, with ``nvidia-smi`` power samples beside it: GFLOP/s,
    mean board W, J a call and GFLOP/s per W for both, beside the paper's
    A100 and M4 Pro columns; B1 and B2 only."""
    from repro_torch.benchmarks import table3_energy
    rec = {"phase": "table3",
           "nvidia_smi": RECORD["phases"][0].get("nvidia_smi")}
    _reset_counts()
    t0 = time.perf_counter()
    lines = []
    rows = table3_energy.main(out=lines.append, device=DEVICE)
    rec["seconds"] = time.perf_counter() - t0
    counts = _read_counts()
    for k, v in counts.items():
        launches[k] += v
        on_path = k in ("csr_panels_spmm", "bcsr_panels_spmm")
        check(v > 0 if on_path else v == 0, f"table3: {k} launched {v} "
              "times")
    print(f"table3 on {rows[0]['card']}, power limit "
          f"{rows[0]['power_limit_w']:.0f} W, idle {rows[0]['idle_w']:.1f} W"
          f" ({rec['nvidia_smi']})", flush=True)
    for r in rows:
        for name in ("loops", "cusparse"):
            m = r[name]
            check(m["seconds"] >= table3_energy.MIN_LOOP_S
                  and m["joules"] > 0 and m["smi_samples"] > 0
                  and 0.5 <= m["smi_mean_w"] / m["mean_w"] <= 2.0,
                  f"table3 {r['matrix']} {name}: {m}")
        print(f"table3 {r['matrix']} {r['name']} ({r['rows']} rows, "
              f"{r['nnz']} nnz): LOOPS {r['loops']['gflops']:.1f} GFLOP/s "
              f"{r['loops']['mean_w']:.1f} W "
              f"{r['loops']['gflops_per_w']:.3f} GFLOP/s/W; cuSPARSE "
              f"({r['cusparse']['dtype']}) {r['cusparse']['gflops']:.1f} "
              f"GFLOP/s {r['cusparse']['mean_w']:.1f} W "
              f"{r['cusparse']['gflops_per_w']:.3f} GFLOP/s/W; paper A100 "
              f"{r['paper_a100_cusparse_fp16_gflops_per_w']}, M4 Pro "
              f"{r['paper_m4pro_loops_gflops_per_w']}", flush=True)
    rec.update(rows=rows, launches=counts)
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 16: the distributed operator, DIST_RANKS ranks on the card
# ---------------------------------------------------------------------------

def _digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _dist_ms(fn, *, samples: int = 5, reps: int = 3) -> float:
    """Host ms a call of the collective ``fn``, every rank in step: the
    median over ``samples`` of ``reps`` calls between a barrier and a
    synchronise, after one warm-up call."""
    import torch
    import torch.distributed as dist
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(times)


def _rank_counts(what: str, counts: dict, want: dict) -> dict:
    for k, v in counts.items():
        w = want.get(k, 0)
        check(v == w, f"{what}: {k} launched {v} times (expected {w})")
    return counts


def _dist_matrix(rank, mesh, world, csr, dname, cache_dir, full: bool) -> dict:
    """One matrix of phase 16 on one rank: ``plan_and_convert``, the split
    (a fresh plan cache: a miss, then a hit), the distributed forward
    against the single-device ``loops_spmm`` on rank 0, and with ``full``
    two calls bitwise equal, the stacked and batched layouts and dB through
    autograd (assembled and stacked) against the single-device flat path's
    autograd on rank 0; the launch counts of the forward and the backward;
    with ``full`` in fp32 the times."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import (distributed_spmm, loops_spmm,
                                  plan_and_convert, shard_loops_auto)
    from repro_torch.tune import PlanCache

    dt = getattr(torch, dname)
    tol = TOL[dname]
    out = {"dtype": dname, "rows": csr.nrows, "nnz": csr.nnz}
    t0 = time.perf_counter()
    fmt, plan = plan_and_convert(csr, device=DEVICE)
    out["plan_and_convert_s"] = time.perf_counter() - t0
    cache = PlanCache(str(cache_dir))
    t0 = time.perf_counter()
    sh = shard_loops_auto(fmt, world, cache=cache)
    out["split_miss_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = shard_loops_auto(fmt, world, cache=cache)
    out["split_hit_s"] = time.perf_counter() - t0
    check((cache.stats.misses, cache.stats.hits) == (1, 1)
          and again.g_vpu == sh.g_vpu, f"distributed {dname}: the split "
          f"cache gave {cache.stats} and g_vpu {again.g_vpu} / {sh.g_vpu}")
    check(sum(sh.row_count) == csr.nrows, f"distributed {dname}: rows "
          f"{sh.row_count} do not sum to {csr.nrows}")
    csr_rank = rank < sh.g_vpu
    o, c = sh.row_offset[rank], sh.row_count[rank]
    out.update(r_boundary=plan.r_boundary, g_vpu=sh.g_vpu,
               rows_pad=int(sh.rows_pad),
               row_count=[int(v) for v in sh.row_count],
               row_offset=[int(v) for v in sh.row_offset],
               group="csr" if csr_rank else "bcsr")
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    b = torch.randn((csr.shape[1], MAIN_N), generator=gen, device=DEVICE,
                    dtype=torch.float32).to(dt)
    dy = torch.randn((csr.nrows, MAIN_N), generator=gen, device=DEVICE,
                     dtype=torch.float32).to(dt)
    b3 = torch.randn((DIST_BATCH,) + tuple(b.shape), generator=gen,
                     device=DEVICE, dtype=torch.float32).to(dt)

    # the main path: the forward calls, then the backward, counted apart
    _reset_counts()
    t0 = time.perf_counter()
    bg = b.clone().requires_grad_()
    y = distributed_spmm(sh, bg, mesh, device=DEVICE)
    torch.cuda.synchronize()
    out["first_call_s"] = time.perf_counter() - t0
    fwd_calls = 1
    if full:
        y2 = distributed_spmm(sh, b, mesh, device=DEVICE)
        st = distributed_spmm(sh, bg, mesh, assemble=False, device=DEVICE)
        y3 = distributed_spmm(sh, b3, mesh, device=DEVICE)
        fwd_calls = 4
    torch.cuda.synchronize()
    part = "csr_panels_spmm" if csr_rank else "bcsr_panels_spmm"
    out["forward_launches"] = _rank_counts(
        f"distributed {dname} rank {rank} forward", _read_counts(),
        {part: fwd_calls if c else 0})
    check(y.shape == (csr.nrows, MAIN_N) and bool(torch.isfinite(y).all()),
          f"distributed {dname}: bad output {tuple(y.shape)}")
    if full:
        _reset_counts()
        t0 = time.perf_counter()
        (db,) = torch.autograd.grad(y, bg, dy)
        loc = st.to_local()
        (db_st,) = torch.autograd.grad(loc[0, :c], bg, dy[o:o + c])
        torch.cuda.synchronize()
        out["first_backward_s"] = time.perf_counter() - t0
        # two backward calls, each B1 / B2 on the parts of the chunk's Aᵀ
        tfmt = sh.chunk(rank).transposed(dtype=dt).fmt if c else None
        want = {} if tfmt is None else {
            "csr_panels_spmm": 2 * int(tfmt.r_boundary > 0),
            "bcsr_panels_spmm": 2 * int(tfmt.r_boundary < tfmt.nrows)}
        out["backward_launches"] = _rank_counts(
            f"distributed {dname} rank {rank} backward", _read_counts(),
            want)
        out["transposed_r_boundary"] = None if tfmt is None else \
            tfmt.r_boundary
        check(torch.equal(y, y2), f"distributed {dname}: two calls differ")
        check(tuple(st.shape) == (world, sh.rows_pad, MAIN_N)
              and torch.equal(loc[0, :c], y[o:o + c])
              and not bool(loc[0, c:].any()),
              f"distributed {dname} rank {rank}: the stacked shard is not "
              "its rows of the assembled result")
        check(torch.equal(db, db_st), f"distributed {dname} rank {rank}: "
              "dB differs between the assembled and the stacked layouts")
        out["db_sha256"] = _digest(db)
        out["y_sha256"] = _digest(y)

    if rank == 0:
        # against the single-device loops_spmm (and its flat path's
        # autograd) on the card; these launches are outside the count
        afmt = abs_format(fmt)
        ref = loops_spmm(fmt, b, device=DEVICE)
        absprod = loops_spmm(afmt, b.abs(), device=DEVICE, backend="torch")
        out["max_abs_err"], out["err_of_absprod"] = sum_err(
            y.detach(), ref, absprod)
        check(out["err_of_absprod"] <= tol, f"distributed {dname} vs "
              f"loops_spmm: {out['err_of_absprod']:.3g} of |A||B| > {tol:g}")
        if full:
            ref3 = loops_spmm(fmt, b3, device=DEVICE)
            e3 = sum_err(y3, ref3, loops_spmm(afmt, b3.abs(), device=DEVICE,
                                              backend="torch"))
            out["batched_err_of_absprod"] = e3[1]
            check(y3.shape == (DIST_BATCH, csr.nrows, MAIN_N)
                  and e3[1] <= tol, f"distributed {dname} batched: "
                  f"{e3[1]:.3g} of |A||B| > {tol:g}")
            bt = b.clone().requires_grad_()
            (db_ref,) = torch.autograd.grad(
                loops_spmm(fmt, bt, device=DEVICE, backend="torch"), bt, dy)
            ba = torch.zeros_like(b).requires_grad_()
            (db_abs,) = torch.autograd.grad(
                loops_spmm(afmt, ba, device=DEVICE, backend="torch"), ba,
                dy.abs())
            out["db_max_abs_err"], out["db_err_of_absprod"] = sum_err(
                db, db_ref, db_abs)
            check(out["db_err_of_absprod"] <= tol, f"distributed {dname} "
                  f"dB vs the flat path: {out['db_err_of_absprod']:.3g} of "
                  f"|A|ᵀ|dY| > {tol:g}")
            del ref3, bt, ba, db_ref, db_abs
        del afmt, ref, absprod
        torch.cuda.synchronize()
    dist.barrier()

    if full and dname == "float32":
        def single():
            loops_spmm(fmt, b, device=DEVICE)
        yt = distributed_spmm(sh, bg, mesh, device=DEVICE)
        out["ms"] = {
            "forward": _dist_ms(lambda: distributed_spmm(sh, b, mesh,
                                                         device=DEVICE)),
            "backward": _dist_ms(lambda: torch.autograd.grad(
                yt, bg, dy, retain_graph=True)),
            "all_gather": _dist_ms(lambda: dist.all_gather(
                [torch.empty_like(loc[0]) for _ in range(world)],
                loc[0].contiguous())),
            "all_reduce_db": _dist_ms(lambda: dist.all_reduce(db.clone()))}
        if rank == 0:
            single()
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                for _ in range(3):
                    single()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3 / 3)
            out["ms"]["single_device"] = statistics.median(times)
        dist.barrier()
    return out


def _dist_psum(rank, world) -> dict:
    """``compressed_psum`` on DIST_PSUM_N fp32 elements a rank: each
    precision within its bound of the exact sum (an fp64 all-reduce), the
    same bits on every rank, its wire bytes on the obs gauge and its host
    ms; then a ``dist.psum.int8`` fault on rank 0 alone, which raises on
    every rank under the default policy and degrades every rank to the
    fp32 sum once opted in."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import compressed_psum
    from repro_torch.obs import Obs, set_active
    from repro_torch.resilience import fallback, inject

    gen = torch.Generator(device=DEVICE).manual_seed(100 + rank)
    x = torch.randn(DIST_PSUM_N, generator=gen, device=DEVICE)
    exact = x.double()
    dist.all_reduce(exact)
    out = {"n": DIST_PSUM_N}
    obs = Obs(source="chip_smoke_distributed")
    prev = set_active(obs)
    try:
        for prec, bound_ in DIST_PSUM_BOUND.items():
            got = compressed_psum(x, None, prec)
            torch.cuda.synchronize()
            err = float((got.double() - exact).abs().max()
                        / exact.abs().max())
            check(err < bound_, f"compressed_psum {prec}: error {err:.3g} "
                  f">= {bound_:g}")
            gauge = obs.metrics.gauge("dist.collective_bytes", kind="psum",
                                      precision=prec).value
            n = DIST_PSUM_N
            want = {"int8": n + 4 * n // world, "bf16": 2 * n,
                    "none": 4 * n}[prec]
            check(gauge == want, f"compressed_psum {prec}: gauge {gauge} "
                  f"bytes, expected {want}")
            out[prec] = {"err": err, "bytes": gauge, "sha256": _digest(got),
                         "ms": _dist_ms(lambda p=prec:
                                        compressed_psum(x, None, p))}
        plain = compressed_psum(x, None, "none")
        inject.set_plan(inject.FaultPlan.parse("dist.psum.int8:raise:0:0")
                        if rank == 0 else None)
        try:
            compressed_psum(x, None, "int8")
            raised = None
        except Exception as e:   # noqa: BLE001 - what raised is the result
            raised = type(e).__name__
        check(raised == ("InjectedFault" if rank == 0 else "RuntimeError"),
              f"compressed_psum rank {rank}: a fault on rank 0 under the "
              f"default policy gave {raised}")
        prev_policy = fallback.set_policy(fallback.FallbackPolicy())
        try:
            degraded = compressed_psum(x, None, "int8")
        finally:
            fallback.set_policy(prev_policy)
            inject.set_plan(None)
        counts = sum(inst.value for kind, inst in obs.metrics.instruments()
                     if kind == "counter" and inst.name == "dist.fallback")
        check(torch.equal(degraded, plain) and counts == 1,
              f"compressed_psum rank {rank}: the opted-in fault gave "
              f"{counts} dist.fallback counts, equal to the fp32 sum: "
              f"{torch.equal(degraded, plain)}")
        out["fault"] = {"default_policy_raised": raised,
                        "opted_in_fallbacks": counts}
    finally:
        set_active(prev)
    return out


def _run_ranks(what: str, target, world: int, work, deadline: float
               ) -> list:
    """Run ``target(rank, world, init_method, work, results)`` in
    ``world`` processes of their own (``spawn``) on a ``file://`` store in
    ``work``; return their records in rank order.  A rank that fails or
    exits without a record, or any still running at ``deadline``
    (``time.perf_counter()``), fails the run; every rank is killed on the
    way out."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=target, args=(
        r, world, f"file://{work}/store", str(work), results))
        for r in range(world)]
    recs, failed = {}, None
    try:
        for p in procs:
            p.start()
        while len(recs) < world and failed is None:
            if time.perf_counter() > deadline:
                failed = "past the phase's limit"
                break
            try:
                r = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    failed = f"a rank exited {dead} without a record"
                continue
            if "error" in r:
                failed = f"rank {r['rank']} failed:\n{r['error']}"
            recs[r["rank"]] = r
        for p in procs:
            p.join(timeout=max(deadline - time.perf_counter(), 5.0)
                   if failed is None else 0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(failed is None, f"{what}: {failed}")
    check(all(p.exitcode == 0 for p in procs), f"{what}: ranks exited "
          f"{[p.exitcode for p in procs]}")
    return [recs[r] for r in range(world)]


def _dist_rank(rank: int, world: int, init_method: str, work: str,
               results) -> None:
    """One rank of phase 16, in a process of its own (``spawn``): puts a
    record, or the traceback of what failed, on ``results``."""
    import traceback
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import datetime

        import numpy as np
        import torch
        import torch.distributed as dist
        from repro_torch.core import suite
        from repro_torch.launch.mesh import backend_for, make_test_mesh

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        backend = backend_for(DEVICE, world)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        mesh = make_test_mesh(1, world, device=DEVICE)
        rec = {"rank": rank, "backend": backend}
        t0 = time.perf_counter()
        rows = next(r for m, r, _ in MAIN_MATRICES if m == "m6")
        base = suite.table2_like("m6", scale_rows=rows, seed=0,
                                 dtype=np.float32)
        rec["m6"] = [
            _dist_matrix(rank, mesh, world, base.astype(np.dtype(dname)),
                         dname, pathlib.Path(work) / f"m6_{dname}_{rank}",
                         full=True)
            for dname in ("float32", "float64")]
        del base
        rows = next(r for m, r, _ in MAIN_MATRICES if m == "m4")
        csr = suite.table2_like("m4", scale_rows=rows, seed=0,
                                dtype=np.float32)
        m4 = _dist_matrix(rank, mesh, world, csr, "float32",
                          pathlib.Path(work) / f"m4_{rank}", full=False)
        # which rank owns the longest row (in-2004's hub)
        hub = int(np.argmax(np.diff(csr.row_ptr)))
        m4["longest_row"] = {"row": hub, "nnz": int(np.diff(
            csr.row_ptr)[hub]), "rank": next(
            d for d, (o, c) in enumerate(zip(m4["row_offset"],
                                             m4["row_count"]))
            if o <= hub < o + c)}
        rec["m4"] = m4
        del csr
        rec["compressed_psum"] = _dist_psum(rank, world)
        rec["seconds"] = time.perf_counter() - t0
        dist.barrier()
        dist.destroy_process_group()
        results.put(rec)
    except BaseException:   # noqa: BLE001 - the parent fails the run on it
        results.put({"rank": rank, "error": traceback.format_exc()})
        raise


def phase_distributed(launches: dict, work_dir) -> dict:
    """Phase 16: ``DIST_RANKS`` ranks, processes of their own (``spawn``)
    sharing the card, run the distributed operator
    (``repro_torch.core.distributed``) through ``make_test_mesh``,
    ``shard_loops_auto`` and ``distributed_spmm``: m6 fp32 and fp64 (the
    split a plan-cache miss then a hit, the forward against the
    single-device ``loops_spmm``, two calls bitwise equal, the stacked and
    batched layouts, dB through autograd against the single-device flat
    path and bitwise equal on every rank), m4 fp32 forward, and
    ``compressed_psum`` (:func:`_dist_psum`).  In the forward a CSR-group
    rank launches B1 alone and a BCSR-group rank B2 alone; B3-B5 never.
    Any rank that fails, or a phase past ``DIST_TIMEOUT_S``, fails the
    run."""
    import torch
    torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    work = pathlib.Path(work_dir) / "distributed"
    work.mkdir()
    t0 = time.perf_counter()
    ranks = _run_ranks("distributed", _dist_rank, DIST_RANKS, work,
                       t0 + DIST_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    counts = {k: 0 for k in KERNELS}
    for r in ranks:
        for m in r["m6"] + [r["m4"]]:
            for key in ("forward_launches", "backward_launches"):
                for k, v in m.get(key, {}).items():
                    counts[k] += v
    for k, v in counts.items():
        launches[k] += v
        check(v > 0 if k.endswith("spmm") else v == 0,
              f"distributed: {k} launched {v} times")
    for i, dname in enumerate(("float32", "float64")):
        for key in ("db_sha256", "y_sha256"):
            digests = {r["m6"][i][key] for r in ranks}
            check(len(digests) == 1, f"distributed m6 {dname}: {key} "
                  f"differs across ranks")
    for prec in DIST_PSUM_BOUND:
        check(len({r["compressed_psum"][prec]["sha256"]
                   for r in ranks}) == 1,
              f"compressed_psum {prec}: ranks disagree")
    m6 = [{**ranks[0]["m6"][i],
           "ms": {k: max(r["m6"][i].get("ms", {}).get(k, 0.0)
                         for r in ranks)
                  for k in ranks[0]["m6"][i].get("ms", {})}}
          for i in range(2)]
    rec = {"phase": "distributed", "ranks": DIST_RANKS,
           "backend": ranks[0]["backend"], "nvidia_smi": smi,
           "note": f"{DIST_RANKS} ranks share one card and move their "
                   "collectives through gloo (host memory): the times show "
                   "the operator's overhead on one card, not multi-GPU "
                   "scaling",
           "m6": m6, "m4": ranks[0]["m4"],
           "compressed_psum": {p: {k: max(r["compressed_psum"][p][k]
                                          for r in ranks)
                                   if k in ("ms", "err") else
                                   ranks[0]["compressed_psum"][p][k]
                                   for k in ("err", "bytes", "ms")}
                               for p in DIST_PSUM_BOUND},
           "fault": [r["compressed_psum"]["fault"] for r in ranks],
           "per_rank": [{"rank": r["rank"], "seconds": r["seconds"],
                         "m6_ms": [m.get("ms") for m in r["m6"]],
                         "launches": [{"fwd": m["forward_launches"],
                                       "bwd": m.get("backward_launches")}
                                      for m in r["m6"] + [r["m4"]]]}
                        for r in ranks],
           "launches": counts, "seconds": seconds}
    ms = m6[0]["ms"]
    print(f"distributed ({rec['backend']}, {DIST_RANKS} ranks on one card; "
          f"{smi}): m6 fp32 forward {ms['forward']:.3f} ms, backward "
          f"{ms['backward']:.3f} ms, single-device {ms['single_device']:.3f}"
          f" ms; phase {seconds:.1f} s", flush=True)
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 17: the LM trained across a data x model mesh
# ---------------------------------------------------------------------------

def _mesh_cfg(dtype=None):
    """The launcher's config under ``MESH_CLI``: its first
    ``MESH_LAYERS`` layers."""
    import dataclasses

    from repro_torch.configs import REDUCED, get_config
    cfg = (REDUCED[LM_ARCH]() if "--reduced" in MESH_CLI
           else get_config(LM_ARCH))
    cfg = dataclasses.replace(cfg, num_layers=min(MESH_LAYERS,
                                                  cfg.num_layers))
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def _mesh_argv(ckpt_dir, *extra) -> list:
    return [*MESH_CLI, "--device", DEVICE, "--seq-len", str(MESH_SEQ),
            "--global-batch", str(MESH_BATCH), "--steps", str(MESH_STEPS),
            "--seed", str(LM_SEED), "--log-every", "1",
            "--mesh-data", str(MESH_SHAPE[0]),
            "--mesh-model", str(MESH_SHAPE[1]), "--ckpt-dir", str(ckpt_dir),
            *extra]


def _mesh_single(cfg) -> dict:
    """The launcher's first two steps on one device (its seed, data and
    schedule): the steps' metrics, and the parameters before and after, on
    the card."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, global_batch_at
    from repro_torch.dist.step import build_train_step, default_microbatches
    from repro_torch.models import api
    from repro_torch.optim import OptConfig, init_opt_state
    shape = ShapeConfig("cli_train", MESH_SEQ, MESH_BATCH, "train")
    n_mb = default_microbatches(shape)
    params = api.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        LM_SEED), device=DEVICE)
    init = {k: v.detach().clone() for k, v in params.named_parameters()}
    step = build_train_step(cfg, params, OptConfig(
        lr=3e-4, total_steps=MESH_STEPS,
        warmup_steps=max(MESH_STEPS // 20, 1)), n_microbatches=n_mb)
    state = init_opt_state(params, 1)
    steps = []
    for i in range(MESH_CKPT_AT):
        batch = global_batch_at(DataConfig(seed=LM_SEED), cfg, shape, n_mb,
                                i, device=DEVICE)
        _, _, m = step(params, state, batch)
        steps.append({k: float(v) for k, v in m.items()})
    new = {k: v.detach().clone() for k, v in params.named_parameters()}
    del params, state, step, batch
    _release()
    return {"steps": steps, "init": init, "new": new}


def _mesh_leaf_errors(ckpt_path, single) -> dict:
    """Each parameter of the mesh's checkpoint against the single-device
    parameters after the same steps: the largest ||mesh - single|| over
    ||single|| (``leaf``, checked) and over ||single - init|| (``update``:
    Adam's first steps move each element by about +-lr, so a gradient
    element near zero whose sign the two summation orders round apart
    moves 2 lr apart), with their leaves."""
    import torch
    from repro_torch.checkpoint import checkpoint as ck
    _, arrays = ck._read(ckpt_path)
    out = {"leaf": 0.0, "leaf_name": None, "update": 0.0,
           "update_name": None}
    for name, new in single["new"].items():
        new = new.float()
        diff = float(torch.linalg.vector_norm(
            arrays[f"params/{name}"].to(DEVICE).float() - new))
        for key, norm in (("leaf", torch.linalg.vector_norm(new)),
                          ("update", torch.linalg.vector_norm(
                              new - single["init"][name].float()))):
            err = diff / max(float(norm), 1e-30)
            if err > out[key]:
                out[key], out[f"{key}_name"] = err, name
    return out


def _wo_ms(cfg) -> dict:
    """One layer's two row-parallel ``wo`` GEMMs (attention, MLP) at a
    (2, 2) rank's shapes, forward and backward without the collective, CUDA
    event ms both ways: as ``layers.row_parallel`` runs them (the half GEMM
    writing out its fp32 accumulator, the backward in the half dtype), and
    with the operands upcast to fp32 (TF32 off); with the largest
    difference of their outputs relative to max |out|, which must be fp32
    summation order's alone."""
    import math

    import torch
    from repro_torch.models import layers
    tokens = MESH_BATCH // MESH_SHAPE[0] * MESH_SEQ
    gen = torch.Generator(device=DEVICE).manual_seed(LM_SEED)
    out = {}
    for name, k in (("attn", cfg.num_heads * cfg.resolved_head_dim
                     // MESH_SHAPE[1]), ("mlp", cfg.d_ff // MESH_SHAPE[1])):
        x = torch.randn((tokens, k), generator=gen, device=DEVICE).to(
            cfg.dtype).requires_grad_()
        w = (torch.randn((k, cfg.d_model), generator=gen, device=DEVICE)
             / math.sqrt(k)).to(cfg.dtype).requires_grad_()
        dy = torch.randn((tokens, cfg.d_model), generator=gen,
                         device=DEVICE).to(cfg.dtype).float()

        def half():
            y = layers._PartialF32.apply(x, w)
            y.backward(dy)
            return y

        def fp32():
            y = torch.matmul(x.float(), w.float())
            y.backward(dy)
            return y

        with torch.no_grad():
            a = layers._PartialF32.apply(x, w)
            b = torch.matmul(x.float(), w.float())
        err = float((a - b).abs().max() / b.abs().max())
        check(err <= 1e-5, f"train_mesh: wo {name} half GEMM with fp32 "
              f"out {err:.3g} of max |out| from the fp32 GEMM")
        out[name] = {"shape": [tokens, k, cfg.d_model],
                     "half_ms": time_ms(half, samples=5, reps=3),
                     "fp32_ms": time_ms(fp32, samples=5, reps=3),
                     "rel_err": err}
        del x, w, dy
    _release()
    return out


def _serve_cli(argv, **kw):
    """``repro_torch.launch.serve.main(argv)`` (its stdout kept in the
    log)."""
    from repro_torch.launch import serve as serve_cli
    _release()
    return serve_cli.main(argv, **kw)


def _first_diff(got: dict, want: dict) -> dict:
    """Per request id: the first token index where ``got``'s stream
    differs from ``want``'s (None where they are equal)."""
    out = {}
    for rid, w in want.items():
        g = got[rid]
        out[rid] = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                        None if len(g) == len(w) else min(len(g), len(w)))
    return out


def _mesh_serve(work, deadline: float) -> dict:
    """Phase 17's serving check, through ``launch/serve.py`` and its
    ``ServeQueue``: on one device here (the graphed pool), then with the
    mesh flags (spawned ranks, eager steps): at ``MESH_SERVE_FP32`` every
    request's fp32 logits against one device's at ``LM_TOL``, the streams
    equal; at ``MESH_SERVE_BF16`` every rank's streams equal rank 0's, and
    the first position where they differ from one device's, decode ms a
    step and tokens/s.  B5 launches once a layer per prefill on every
    rank."""
    import numpy as np
    import torch
    cfg = _mesh_cfg()
    out = {}
    for tag, (mesh, bsz, prompt, gen, dtype) in (
            ("fp32", MESH_SERVE_FP32), ("bf16", MESH_SERVE_BF16)):
        argv = [*MESH_CLI, "--device", DEVICE, "--batch", str(bsz),
                "--prompt-len", str(prompt), "--gen-len", str(gen),
                "--seed", str(LM_SEED), "--max-batch", "8", "--dtype",
                dtype]
        one_npz, mesh_npz = work / f"one_{tag}.npz", work / f"mesh_{tag}.npz"
        if tag == "fp32":
            argv_one = argv + ["--logits-out", str(one_npz)]
            argv_mesh = argv + ["--logits-out", str(mesh_npz)]
        else:
            argv_one = argv_mesh = argv
        _reset_counts()
        one = _serve_cli(argv_one)
        torch.cuda.synchronize()
        one_counts = _read_counts()
        want = {r.rid: r.tokens for r in one.completed}
        one_rec = {"decode_ms_median": statistics.median(
            one.engine_s["decode"]) * 1e3, "prefill_ms": [
            t * 1e3 for t in one.engine_s["prefill"]],
            "prefill_calls": one.sched.counters["prefill_batches"],
            "slots": one.pool.slots}
        del one
        # the one-device pool: one eager prefill a slot before its capture,
        # then one replay a prefill call
        _check_lm_launches(f"train_mesh serving {tag} one device",
                           one_counts, cfg.num_layers * (
                               one_rec["prefill_calls"] + one_rec["slots"]),
                           {k: 0 for k in KERNELS})
        _reset_counts()
        rec = _serve_cli(argv_mesh + ["--mesh-data", str(mesh[0]),
                                      "--mesh-model", str(mesh[1])],
                         timeout_s=deadline - time.perf_counter())
        check(_read_counts() == {k: 0 for k in KERNELS}, "train_mesh "
              "serving: a kernel launched in the spawning process")
        n_pre = rec["counters"]["prefill_batches"]
        for r in rec["per_rank"]:
            check(r["streams"] == rec["streams"], f"train_mesh serving "
                  f"{tag}: rank {r['rank']}'s streams differ from rank 0's")
            check(r["launches"]["flash_attention"] == cfg.num_layers * n_pre,
                  f"train_mesh serving {tag}: rank {r['rank']} launched B5 "
                  f"{r['launches']['flash_attention']} times for {n_pre} "
                  "prefill calls")
            check(r["local_heads"] == cfg.num_heads // mesh[1]
                  and r["launches"]["wkv6"] == 0,
                  f"train_mesh serving {tag}: rank {r['rank']} ran "
                  f"{r['local_heads']} heads, launched wkv6 "
                  f"{r['launches']['wkv6']} times")
        check(rec["completed"] == bsz and all(
            len(t) == gen for t in rec["streams"].values()),
            f"train_mesh serving {tag}: {rec['completed']} of {bsz} "
            "requests served")
        res = {"mesh": mesh, "requests": bsz, "prompt_len": prompt,
               "gen_len": gen, "dtype": dtype,
               "first_diff_from_one_device": _first_diff(rec["streams"],
                                                         want),
               "decode_ms_median": statistics.median(
                   rec["engine_s"]["decode"]) * 1e3,
               "prefill_ms": [t * 1e3 for t in rec["engine_s"]["prefill"]],
               "tokens_per_s": rec["tokens_per_s"],
               "ttft_ms": [t * 1e3 for t in rec["ttft_s"]],
               "served_s": rec["served_s"], "pool": rec["pool"],
               "peak_mem_gb_per_rank": [r["peak_mem_gb"]
                                        for r in rec["per_rank"]],
               "launches_per_rank": [r["launches"]
                                     for r in rec["per_rank"]],
               "one_device": one_rec, "one_device_launches": one_counts}
        if tag == "fp32":
            check(rec["streams"] == want, "train_mesh serving fp32: the "
                  f"streams differ from one device's at "
                  f"{res['first_diff_from_one_device']}")
            got, ref = np.load(mesh_npz), np.load(one_npz)
            res["logits_err"] = {
                rid: [_lm_logits_err(f"train_mesh {mesh} fp32 logits, "
                                     f"request {rid} token {i}",
                                     torch.from_numpy(g), torch.from_numpy(w))
                      for i, (g, w) in enumerate(zip(got[rid], ref[rid]))]
                for rid in ref.files}
        out[tag] = res
    return out


def phase_train_mesh(launches: dict, work_dir) -> dict:
    """Phase 17 (the module docstring): the single-device steps, the
    launcher on the (2, 2) mesh (run A, then run B resumed from A's
    checkpoint), the checkpoint's parameters against the single-device
    update, and the (1, 2) serving check."""
    import os
    import shutil

    from repro_torch.launch import train as train_cli
    t0 = time.perf_counter()
    deadline = t0 + MESH_LIMIT_S
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cfg = _mesh_cfg()
    _release()
    wo = _wo_ms(cfg)
    single = _mesh_single(cfg)
    t_single = time.perf_counter() - t0
    work = pathlib.Path(work_dir) / "train_mesh"
    dir_a, dir_b = work / "a", work / "b"
    work.mkdir()
    ckpt = f"ckpt_{MESH_CKPT_AT:010d}.tensors"
    try:
        run_a = train_cli.main(_mesh_argv(dir_a, "--ckpt-every",
                                          str(MESH_CKPT_AT),
                                          "--no-final-ckpt"),
                               timeout_s=deadline - time.perf_counter())
        leaf = _mesh_leaf_errors(str(dir_a / ckpt), single)
        single_steps = single["steps"]
        del single
        _release()
        os.makedirs(dir_b)
        os.link(dir_a / ckpt, dir_b / ckpt)
        shutil.rmtree(dir_a)     # the disk holds two full checkpoints
        run_b = train_cli.main(_mesh_argv(dir_b, "--resume",
                                          "--no-final-ckpt"),
                               timeout_s=deadline - time.perf_counter())
    finally:
        shutil.rmtree(dir_a, ignore_errors=True)
        shutil.rmtree(dir_b, ignore_errors=True)
    t_train = time.perf_counter() - t0
    serve = _mesh_serve(work, deadline)
    seconds = time.perf_counter() - t0

    ranks = MESH_SHAPE[0] * MESH_SHAPE[1]
    n_mb = run_a["n_microbatches"]
    rel = {}
    for i, s1 in enumerate(single_steps):
        a = run_a["steps"][i]
        rel[i] = {k: abs(a[k] - s1[k]) / abs(s1[k])
                  for k in ("loss", "grad_norm")}
    check(rel[0]["loss"] <= MESH_LOSS_TOL, f"train_mesh: step-0 loss "
          f"{run_a['steps'][0]['loss']} vs {single_steps[0]['loss']} on "
          "one device")
    check(rel[0]["grad_norm"] <= MESH_GNORM_TOL, f"train_mesh: step-0 "
          f"gradient norm {run_a['steps'][0]['grad_norm']} vs "
          f"{single_steps[0]['grad_norm']} on one device")
    check(leaf["leaf"] <= MESH_LEAF_TOL, f"train_mesh: {leaf['leaf_name']} "
          f"after {MESH_CKPT_AT} steps {leaf['leaf']:.3g} of its norm from "
          "the single-device one")
    check(run_b["start_step"] == MESH_CKPT_AT,
          f"train_mesh: resumed at {run_b['start_step']}")
    same = []
    for ra, rb in zip(run_a["per_rank"], run_b["per_rank"]):
        for key in ("loss", "grad_norm"):
            same.append(ra[key][MESH_CKPT_AT:] == rb[key])
    check(len(run_b["per_rank"]) == ranks and all(same),
          f"train_mesh: resumed steps {[r['loss'] for r in run_b['per_rank']]}"
          f" differ from the uninterrupted run's "
          f"{[r['loss'][MESH_CKPT_AT:] for r in run_a['per_rank']]}")
    per_step = 2 * cfg.num_layers * n_mb    # forward and remat recompute
    b5 = 0
    for run, steps in ((run_a, MESH_STEPS),
                       (run_b, MESH_STEPS - MESH_CKPT_AT)):
        for r in run["per_rank"]:
            n = r["launches"]["flash_attention"]
            b5 += n
            check(n == per_step * steps, f"train_mesh: rank {r['rank']} "
                  f"launched B5 {n} times (expected {per_step * steps})")
            check(r["local_heads"] == cfg.num_heads // MESH_SHAPE[1],
                  f"train_mesh: rank {r['rank']} ran {r['local_heads']} "
                  "heads")
            check(r["peak_mem_gb"] < 80, f"train_mesh: rank {r['rank']} "
                  f"peak {r['peak_mem_gb']:.1f} GB")
    for res in serve.values():
        b5 += res["one_device_launches"]["flash_attention"]
        b5 += sum(r["flash_attention"] for r in res["launches_per_rank"])
    launches["flash_attention"] += b5
    check(seconds <= MESH_LIMIT_S, f"train_mesh: {seconds:.1f} s, past "
          f"the phase's {MESH_LIMIT_S} s")

    step_ms = [[t * 1e3 for t in r["step_s"]] for r in run_a["per_rank"]]
    slowest = [max(col) for col in zip(*step_ms)]
    med = statistics.median(slowest[1:] or slowest)
    rec = {"phase": "train_mesh", "nvidia_smi": smi, "arch": cfg.name,
           "dtype": str(cfg.dtype), "mesh": list(MESH_SHAPE),
           "seq_len": MESH_SEQ, "global_batch": MESH_BATCH,
           "n_microbatches": n_mb, "backend": "gloo, CUDA tensors",
           "note": "4 ranks share one card and move their collectives "
                   "through gloo (host memory): the times show what the "
                   "mesh costs on one card, not tensor-parallel speed",
           "single_device": single_steps, "steps": run_a["steps"],
           "rel_err": rel, "leaf_err": leaf, "resumed_steps": run_b["steps"],
           "resumed_equal_bitwise": all(same),
           "step_ms_per_rank": step_ms, "step_ms_slowest": slowest,
           "median_step_ms_slowest": med,
           "tokens_per_s": MESH_BATCH * MESH_SEQ / (med / 1e3),
           "peak_mem_gb_per_rank": [r["peak_mem_gb"]
                                    for r in run_a["per_rank"]],
           "ckpt_saves": run_a["ckpt"] + run_b["ckpt"],
           "restore_s": run_b["restore_s"], "serve": serve, "wo": wo,
           "launches_per_rank": {"run_a": [r["launches"] for r in
                                           run_a["per_rank"]],
                                 "run_b": [r["launches"] for r in
                                           run_b["per_rank"]]},
           "single_s": t_single, "train_s": t_train, "seconds": seconds}
    wo_ms = {k: (round(v["half_ms"], 3), round(v["fp32_ms"], 3))
             for k, v in wo.items()}
    fp32_err = max(max(v) for v in serve["fp32"]["logits_err"].values())
    print(f"train_mesh ({MESH_SHAPE[0]}x{MESH_SHAPE[1]} on one card, gloo; "
          f"{smi}): step ms per rank "
          f"{[[round(t, 1) for t in r] for r in step_ms]}, slowest median "
          f"{med:.1f}, {rec['tokens_per_s']:.0f} tok/s; step-0 loss "
          f"{rel[0]['loss']:.2e}, norm {rel[0]['grad_norm']:.2e}, leaf "
          f"{leaf['leaf']:.2e} (update {leaf['update']:.2e}); serving "
          f"(2, 2) bf16 decode {serve['bf16']['decode_ms_median']:.1f} ms "
          f"a step (one device "
          f"{serve['bf16']['one_device']['decode_ms_median']:.1f}), "
          f"{serve['bf16']['tokens_per_s']:.1f} tok/s, first differing "
          f"token {serve['bf16']['first_diff_from_one_device']}; (1, 2) "
          f"fp32 logits {fp32_err:.2e}; wo GEMMs ms (half with fp32 out, "
          f"fp32) {wo_ms}; peak GB "
          f"{[round(g, 1) for g in rec['peak_mem_gb_per_rank']]}; restore "
          f"{run_b['restore_s']:.1f} s; phase {seconds:.1f} s", flush=True)
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 18: the dense family's other configs, served
# ---------------------------------------------------------------------------

def _dense_cfg(arch: str, layers: int | None = None, dtype=None):
    import dataclasses

    from repro_torch.configs import REDUCED, get_config
    cfg = REDUCED[arch]() if DENSE_REDUCED else get_config(arch)
    kw = {}
    if layers is not None and layers < cfg.num_layers:
        kw["num_layers"] = layers
    if dtype is not None:
        kw["dtype"] = dtype
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _serve_dense_one(cfg, launches: dict, what: str = "serve_dense",
                     profile: bool = False) -> dict:
    """``cfg`` served at ``DENSE_BATCH`` x (``DENSE_PROMPT`` +
    ``DENSE_GEN``), greedy, through ``ServeQueue`` and its graphed pool
    (the bucket warmed before traffic): init s, prefill ms, TTFT, decode ms
    a step, tokens/s and peak GB; B5 once a layer per prefill replay (the
    ssm family: wkv6 once a layer per prefill replay and decode step, B5
    never); then,
    the pool freed, the served stream against the eager path's
    (``api.prefill`` / ``api.decode_step`` into a cache of the bucket's
    length, teacher-forced with the served tokens): equal.  ``profile``:
    then one eager decode step and one eager prefill under
    :func:`profile_step` (their kernels by device time)."""
    import numpy as np
    import torch
    from repro_torch.models import api
    from repro_torch.serve.queue import (DEFAULT_LEN_QUANTUM, ExecutorPool,
                                         ServeQueue)
    from repro_torch.serve.scheduler import SchedulerConfig

    _release()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(LM_SEED),
        device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = api.num_params(params)
    rng = np.random.default_rng(LM_SEED + 1)
    prompts = rng.integers(0, cfg.vocab_size, (DENSE_BATCH, DENSE_PROMPT))
    max_len = DENSE_PROMPT + -(-DENSE_GEN // DEFAULT_LEN_QUANTUM) * \
        DEFAULT_LEN_QUANTUM
    pool = ExecutorPool(cfg, params)
    t0 = time.perf_counter()
    pool.warm([(DENSE_BATCH, DENSE_PROMPT, max_len)])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    queue = ServeQueue(cfg, params, config=SchedulerConfig(max_batch=8),
                       pool=pool)
    _reset_counts()
    t0 = time.perf_counter()
    reqs = [queue.submit(row.tolist(), DENSE_GEN) for row in prompts]
    queue.drain()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = _read_counts()
    n_prefill = queue.sched.counters["prefill_batches"]
    n_decode = queue.sched.counters["decode_steps"]
    if cfg.family == "ssm":
        _check_lm_launches(f"{what} {cfg.name}", counts, 0, launches,
                           cfg.num_layers * (n_prefill + n_decode))
    else:
        _check_lm_launches(f"{what} {cfg.name}", counts,
                           cfg.num_layers * n_prefill, launches)
    served = np.array([r.tokens for r in reqs])
    check(n_prefill == 1 and served.shape == (DENSE_BATCH, DENSE_GEN)
          and 0 <= served.min() and served.max() < cfg.vocab_size,
          f"{what} {cfg.name}: {n_prefill} prefill calls, tokens "
          f"{served.shape}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_ms = [t * 1e3 for t in queue.engine_s["decode"]]
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "dtype": str(cfg.dtype), "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.resolved_head_dim, "qk_norm": cfg.qk_norm,
           "vocab": cfg.vocab_size, "init_s": init_s, "warm_s": warm_s,
           "serve_s": serve_s,
           "prefill_ms": [t * 1e3 for t in queue.engine_s["prefill"]],
           "ttft_ms": [r.wall_ttft_s * 1e3 for r in reqs],
           "decode_ms_median": statistics.median(decode_ms),
           "decode_ms": decode_ms, "tokens_per_s": served.size / serve_s,
           "decode_steps": n_decode,
           "decode_floor_ms": _decode_floor_ms(params, pool),
           "peak_mem_gb": peak_gb,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "launches": counts}
    del queue, pool
    _release()
    # the eager path, teacher-forced with the served tokens (a comparison:
    # its launches are not the path's)
    toks = torch.as_tensor(served, device=DEVICE)
    cache = api.init_cache(cfg, DENSE_BATCH, max_len, device=DEVICE)
    _, logits = api.prefill(cfg, params, {"tokens": torch.as_tensor(
        prompts, device=DEVICE)}, cache=cache)
    same = [logits[:, :cfg.vocab_size].argmax(-1) == toks[:, 0]]
    for i in range(DENSE_GEN - 1):
        _, logits = api.decode_step(cfg, params, cache, toks[:, i:i + 1],
                                    DENSE_PROMPT + i)
        same.append(logits[:, :cfg.vocab_size].argmax(-1) == toks[:, i + 1])
    agree = torch.stack(same, 1)
    torch.cuda.synchronize()
    rec["eager_agreement"] = float(agree.float().mean())
    check(bool(agree.all()), f"{what} {cfg.name}: the served stream "
          f"differs from the eager path's (agreement "
          f"{rec['eager_agreement']:.4f})")
    if profile:   # where an eager step's device time goes
        rec["profile"] = {
            "decode": profile_step(lambda: api.decode_step(
                cfg, params, cache, toks[:, :1], DENSE_PROMPT)),
            "prefill": profile_step(lambda: api.prefill(
                cfg, params, {"tokens": torch.as_tensor(prompts,
                                                        device=DEVICE)},
                cache=cache))}
    del params, cache, logits
    _release()
    print(f"{what} {cfg.name} ({cfg.num_layers} layers, "
          f"{n_params / 1e9:.2f}B parameters): prefill "
          f"{rec['prefill_ms'][0]:.1f} ms, decode "
          f"{rec['decode_ms_median']:.2f} ms a step, "
          f"{rec['tokens_per_s']:.1f} tok/s, peak {peak_gb:.1f} GB",
          flush=True)
    return rec


def _decode_floor_ms(params, pool) -> float:
    """The least time of a decode step of the pool's model at 3.35 TB/s:
    every parameter read once and the slot's cache read once, and an ssm
    state (all of it) written once (a KV cache's write, one position, is
    left out)."""
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    (bundle,) = pool._bundles.values()
    cache = bundle.slots[0].cache
    nbytes = sum(t.numel() * t.element_size() for t in cache.values())
    return (weights + nbytes * (2 if "s" in cache else 1)) \
        / HBM_BYTES_PER_S * 1e3


def _dense_fp32_check(cfg) -> dict:
    """``cfg`` (fp32) on one ``DENSE_PROMPT`` prompt and
    ``DENSE_CHECK_STEPS`` teacher-forced decode steps, through B5 and
    through the plain attention path: the logits at ``LM_TOL``.  The ssm
    family runs wkv6 (once a layer per call) against the recurrence's
    plain loop instead."""
    import numpy as np
    import torch
    from repro_torch.models import api
    _release()
    params = api.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(LM_SEED),
        device=DEVICE)
    rng = np.random.default_rng(LM_SEED + 2)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (1, DENSE_PROMPT + DENSE_CHECK_STEPS)),
        device=DEVICE)

    def run(backend):
        cache = api.init_cache(cfg, 1, toks.shape[1], device=DEVICE)
        _, logits = api.prefill(cfg, params,
                                {"tokens": toks[:, :DENSE_PROMPT]},
                                backend=backend, cache=cache)
        outs = [logits]
        for i in range(DENSE_CHECK_STEPS):
            _, logits = api.decode_step(
                cfg, params, cache,
                toks[:, DENSE_PROMPT + i:DENSE_PROMPT + i + 1],
                DENSE_PROMPT + i, backend=backend)
            outs.append(logits)
        return outs
    ssm = cfg.family == "ssm"
    what = f"serve_{'ssm' if ssm else 'dense'} fp32 {cfg.name}"
    fn = _kernel_fns()["wkv6" if ssm else "flash_attention"]
    per_layer = 1 + DENSE_CHECK_STEPS if ssm else 1
    n0 = fn.launches
    kernel = run(None)
    check(fn.launches == n0 + cfg.num_layers * per_layer,
          f"{what}: {fn.__name__} did not launch once a layer per call")
    before = _read_counts()
    plain = run("torch")
    torch.cuda.synchronize()
    check(_read_counts() == before, f"{what}: the plain path launched a "
          "kernel")
    errs = [_lm_logits_err(f"{what} logits step {i}", g, w)
            for i, (g, w) in enumerate(zip(kernel, plain))]
    del params, kernel, plain
    _release()
    return {"arch": cfg.name, "layers": cfg.num_layers, "dtype": "float32",
            "prompt_len": DENSE_PROMPT, "decode_steps": DENSE_CHECK_STEPS,
            "logits_err_rel": errs}


def phase_serve_dense(launches: dict) -> dict:
    """Phase 18 (the module docstring): qwen3-32b at full width and depth
    served in bf16, its first ``DENSE_CHECK_LAYERS`` layers' fp32 logits
    through B5 against the plain path, and granite-34b and internlm2-20b
    at full width, ``DENSE_CUT_LAYERS`` layers each."""
    import torch
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    n0 = launches["flash_attention"]
    full = _serve_dense_one(_dense_cfg(DENSE_ARCH), launches)
    check(full["peak_mem_gb"] < 80, f"serve_dense {DENSE_ARCH}: peak "
          f"{full['peak_mem_gb']:.1f} GB")
    fp32 = _dense_fp32_check(_dense_cfg(DENSE_ARCH, DENSE_CHECK_LAYERS,
                                        torch.float32))
    cut = [_serve_dense_one(_dense_cfg(arch, DENSE_CUT_LAYERS), launches)
           for arch in DENSE_CUT]
    rec = {"phase": "serve_dense",
           "nvidia_smi": RECORD["phases"][0].get("nvidia_smi"),
           "requests": DENSE_BATCH, "prompt_len": DENSE_PROMPT,
           "gen_len": DENSE_GEN, "served": [full] + cut, "fp32_check": fp32,
           "b5_launches": launches["flash_attention"] - n0,
           "seconds": time.perf_counter() - t0}
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 20: the moe family, served
# ---------------------------------------------------------------------------

def _moe_fp32_check(cfg) -> dict:
    """``cfg`` (fp32) on one ``DENSE_PROMPT`` prompt and
    ``DENSE_CHECK_STEPS`` teacher-forced decode steps, through B5 and
    through the plain attention path.  The plain run routes every call as
    the B5 run did (its own softmax weights at B5's expert ids), so a
    near-tie that attention's rounding flips changes no later token and
    every call's logits are held to ``LM_TOL``; the rows (layer x token)
    where the plain path's own top-k picks other experts are counted, at
    most ``MOE_FLIP_LIMIT`` of all."""
    import numpy as np
    import torch
    from repro_torch.models import api
    from repro_torch.models import moe as moe_lib
    _release()
    params = api.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(LM_SEED),
        device=DEVICE)
    rng = np.random.default_rng(LM_SEED + 2)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (1, DENSE_PROMPT + DENSE_CHECK_STEPS)),
        device=DEVICE)
    real = moe_lib._route

    def run(backend, forced=None):
        """Each call's logits, and each routing's ``(own ids, ids used)``;
        ``forced``: the ids to route by, one a routing, in order."""
        routes = []

        def spy(router_w, x2d, num_experts, top_k):
            weights, idx = real(router_w, x2d, num_experts, top_k)
            own = idx
            if forced is not None:   # _route's softmax, at B5's ids
                idx = forced[len(routes)]
                logits = x2d.to(torch.float32) @ router_w.to(torch.float32)
                logits[:, num_experts:] = -1e30
                weights = torch.softmax(logits, -1).gather(-1, idx)
                weights = weights / weights.sum(-1, keepdim=True
                                                ).clamp_min(1e-9)
            routes.append((own, idx))
            return weights, idx
        moe_lib._route = spy
        try:
            cache = api.init_cache(cfg, 1, toks.shape[1], device=DEVICE)
            _, logits = api.prefill(cfg, params,
                                    {"tokens": toks[:, :DENSE_PROMPT]},
                                    backend=backend, cache=cache)
            outs = [logits]
            for i in range(DENSE_CHECK_STEPS):
                _, logits = api.decode_step(
                    cfg, params, cache,
                    toks[:, DENSE_PROMPT + i:DENSE_PROMPT + i + 1],
                    DENSE_PROMPT + i)
                outs.append(logits)
        finally:
            moe_lib._route = real
        return outs, routes
    n0 = _kernel_fns()["flash_attention"].launches
    kernel, k_routes = run(None)
    check(_kernel_fns()["flash_attention"].launches == n0 + cfg.num_layers,
          f"serve_moe fp32 {cfg.name}: B5 did not launch once a layer")
    plain, p_routes = run("torch", [used for _, used in k_routes])
    torch.cuda.synchronize()
    L = cfg.num_layers
    check(len(k_routes) == len(p_routes) == L * (1 + DENSE_CHECK_STEPS),
          f"serve_moe fp32 {cfg.name}: {len(k_routes)} / {len(p_routes)} "
          f"routings")
    flips = [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
             for (a, _), (b, _) in zip(k_routes, p_routes)]
    rows = sum(int(a.shape[0]) for a, _ in k_routes)
    errs = [_lm_logits_err(f"serve_moe fp32 {cfg.name} logits step {i}",
                           g, w) for i, (g, w) in enumerate(zip(kernel,
                                                                plain))]
    check(sum(flips) <= MOE_FLIP_LIMIT * rows,
          f"serve_moe fp32 {cfg.name}: {sum(flips)} of {rows} routed rows "
          f"flipped between B5 and the plain path")
    print(f"serve_moe fp32 {cfg.name}: {sum(flips)} of {rows} routed rows "
          f"flipped; logits errors {['%.3g' % e for e in errs]}",
          flush=True)
    del params, kernel, plain
    _release()
    return {"arch": cfg.name, "layers": L, "dtype": "float32",
            "prompt_len": DENSE_PROMPT, "decode_steps": DENSE_CHECK_STEPS,
            "routed_rows": rows, "flipped_rows": sum(flips),
            "flips_per_call": flips, "logits_err_rel": errs}


def phase_serve_moe(launches: dict) -> dict:
    """Phase 20 (the module docstring): qwen3-moe-30b-a3b at full width
    and depth served in bf16 (below 80 GB), qwen2-moe-a2.7b at full width
    and ``MOE_CUT_LAYERS`` layers, each as phase 18 serves (B5 once a
    layer per prefill replay, the served stream equal to the eager
    path's); then both at ``MOE_CHECK_LAYERS`` layers in fp32, B5 against
    the plain path with the routes compared."""
    import torch
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    n0 = launches["flash_attention"]
    full = _serve_dense_one(_dense_cfg(MOE_ARCH), launches, "serve_moe",
                            profile=True)
    check(full["peak_mem_gb"] < 80, f"serve_moe {MOE_ARCH}: peak "
          f"{full['peak_mem_gb']:.1f} GB")
    cut = _serve_dense_one(_dense_cfg(MOE_CUT, MOE_CUT_LAYERS), launches,
                           "serve_moe")
    fp32 = [_moe_fp32_check(_dense_cfg(arch, MOE_CHECK_LAYERS,
                                       torch.float32))
            for arch in (MOE_ARCH, MOE_CUT)]
    rec = {"phase": "serve_moe",
           "nvidia_smi": RECORD["phases"][0].get("nvidia_smi"),
           "requests": DENSE_BATCH, "prompt_len": DENSE_PROMPT,
           "gen_len": DENSE_GEN, "served": [full, cut], "fp32_check": fp32,
           "b5_launches": launches["flash_attention"] - n0,
           "seconds": time.perf_counter() - t0}
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 21: the ssm family, served
# ---------------------------------------------------------------------------

def wkv6_bound(r, *, zero_s0: bool) -> dict:
    """Least time of one wkv6 call: r, k, v, w and u read once, the state
    read once (not from a zero start) and written once, y written once;
    its 5 flops a state element and step and 5 a head row, at the fp32
    peak."""
    bsz, seq, heads, n = r.shape
    elems = bsz * seq * heads * n
    state = bsz * heads * n * n
    nbytes = 4 * (5 * elems + heads * n + state * (1 if zero_s0 else 2))
    flops = bsz * seq * heads * (5 * n * n + 5 * n)
    return bound(bytes_moved=float(nbytes), flops=float(flops),
                 dtype="float32")


def _wkv6_timed(bsz: int, seq: int, heads: int, nonzero: bool, *,
                plain: bool = False) -> dict:
    """wkv6 on :func:`_wkv6_inputs` (a zero start unless ``nonzero``, the
    state written into a buffer of its own): its time, its plain loop's
    when ``plain`` (the host clock around the one synchronised call that
    gives the reference), its error against the plain loop and its bound.
    No single PyTorch call computes the recurrence (``library_ms``
    None)."""
    import torch
    from repro_torch.kernels import wkv6
    r, k, v, w, u, s0 = _wkv6_inputs(bsz, seq, heads, nonzero, seed=10)
    start = s0 if nonzero else None
    state = torch.empty_like(s0)
    y, _ = wkv6.wkv6(r, k, v, w, u, start, state=state)
    (want_y, want_s), plain_ms = timed_call(
        lambda: wkv6.wkv6_plain(r, k, v, w, u, start))
    err = max(float((y - want_y).abs().max()),
              float((state - want_s).abs().max()))
    rec = {"shape": [bsz, seq, heads, 64], "s0": "state" if nonzero
           else "zero", "dtype": "float32",
           "ms": time_ms(lambda: wkv6.wkv6(r, k, v, w, u, start,
                                           state=state)),
           "plain_ms": plain_ms if plain else None,
           "library_ms": None, "library": None,
           "max_abs_err": err,
           "max_abs_plain": float(want_y.abs().max()),
           **wkv6_bound(r, zero_s0=not nonzero)}
    rec.update(rate(rec))
    return rec


def phase_serve_ssm(launches: dict) -> dict:
    """Phase 21 (the module docstring): rwkv6-3b at full width and depth
    served in bf16 as phase 18 serves (wkv6 once a layer per prefill
    replay and decode step, the served stream equal to the eager path's),
    its decode step against the bytes floor; wkv6 alone at the serving
    prefill's shape and at a decode step's; then ``SSM_CHECK_LAYERS``
    layers in fp32, wkv6 against the recurrence's plain loop."""
    import torch
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    n0 = launches["wkv6"]
    full = _serve_dense_one(_dense_cfg(SSM_ARCH), launches, "serve_ssm",
                            profile=True)
    check(full["peak_mem_gb"] < 80, f"serve_ssm {SSM_ARCH}: peak "
          f"{full['peak_mem_gb']:.1f} GB")
    n_served = launches["wkv6"] - n0
    _release()
    alone = _wkv6_timed(DENSE_BATCH, DENSE_PROMPT, full["d_model"] // 64,
                        False, plain=True)
    alone["variants"] = [_wkv6_timed(DENSE_BATCH, 1, full["d_model"] // 64,
                                     True)]
    fp32 = _dense_fp32_check(_dense_cfg(SSM_ARCH, SSM_CHECK_LAYERS,
                                        torch.float32))
    rec = {"phase": "serve_ssm",
           "nvidia_smi": RECORD["phases"][0].get("nvidia_smi"),
           "requests": DENSE_BATCH, "prompt_len": DENSE_PROMPT,
           "gen_len": DENSE_GEN, "served": [full], "fp32_check": fp32,
           "wkv6_alone": alone, "wkv6_launches": n_served,
           "seconds": time.perf_counter() - t0}
    print(f"serve_ssm {SSM_ARCH}: decode {full['decode_ms_median']:.2f} ms "
          f"a step against a {full['decode_floor_ms']:.2f} ms floor; wkv6 "
          f"alone {alone['ms']:.4f} ms (plain {alone['plain_ms']:.1f}, "
          f"bound {alone['bound_ms']:.4f}), a decode step's "
          f"{alone['variants'][0]['ms']:.4f} ms; fp32 logits errors "
          f"{['%.3g' % e for e in fp32['logits_err_rel']]}", flush=True)
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 22: the ssm family, trained
# ---------------------------------------------------------------------------

def wkv6_bwd_bound(r, *, nonzero: bool) -> dict:
    """Least time of one wkv6_bwd call: r, k, v, w, dy and u read once (and
    dS_T when given), dr, dk, dv, dw, du and dS_0 written once (the
    snapshots are the pair's workspace); the function's flops (14 a state
    element and step, 15 a step's row: the bonus terms as row scalars), at
    the fp32 peak."""
    bsz, seq, heads, n = r.shape
    elems = bsz * seq * heads * n
    state = bsz * heads * n * n
    nbytes = 4 * (9 * elems + 2 * heads * n + state * (2 if nonzero else 1))
    flops = bsz * seq * heads * (14 * n * n + 15 * n)
    return bound(bytes_moved=float(nbytes), flops=float(flops),
                 dtype="float32")


def _wkv6_bwd_alone() -> dict:
    """wkv6_bwd at the training shape (TRAIN_BATCH / 2 x TRAIN_SEQ, 40
    heads of 64, from a zero state: one microbatch of phase 22's layer),
    on the forward kernel's snapshots: its time, its plain version's (the
    host clock around the one synchronised call that gives the reference),
    its error against it and its bound.  No single PyTorch call computes the
    recurrence's derivative (``library_ms`` None)."""
    import torch
    from repro_torch.kernels import wkv6
    bsz = TRAIN_BATCH // 2
    args, _, _ = _wkv6_bwd_case(bsz, TRAIN_SEQ, 40, False, seed=31)
    r, k, v, w, u, dy, _, _ = args
    got = wkv6.wkv6_bwd(*args)
    want, plain_ms = timed_call(
        lambda: wkv6.wkv6_bwd_plain(r, k, v, w, u, dy))
    err = max(float((g - x).abs().max()) for g, x in zip(got, want))
    rec = {"shape": [bsz, TRAIN_SEQ, 40, 64], "s0": "zero",
           "dtype": "float32",
           "ms": time_ms(lambda: wkv6.wkv6_bwd(*args)),
           "plain_ms": plain_ms,
           "forward_with_snapshots_ms": time_ms(
               lambda: wkv6.wkv6(r, k, v, w, u, snapshots=True)),
           "forward_serving_ms": time_ms(lambda: wkv6.wkv6(r, k, v, w, u)),
           "library_ms": None, "library": None, "max_abs_err": err,
           "max_abs_plain": max(float(x.abs().max()) for x in want),
           **wkv6_bwd_bound(r, nonzero=False)}
    rec.update(rate(rec))
    del args, got, want
    _release()
    return rec


def _ssm_step0_check(launches: dict) -> dict:
    """Step 0 of rwkv6-3b at full width and ``SSM_CHECK_LAYERS`` layers in
    fp32 on 1 x ``SSM_CHECK_SEQ`` tokens: ``train_loss``'s loss and every
    gradient leaf through wkv6 (forward and the checkpoint's recompute)
    and wkv6_bwd against ``backend="torch"`` (the recurrence's plain loop,
    differentiated by autograd) on the same weights and tokens."""
    import numpy as np
    import torch
    from repro_torch.models import api
    cfg = _dense_cfg(SSM_ARCH, SSM_CHECK_LAYERS, torch.float32)
    params = api.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        LM_SEED), device=DEVICE)
    rng = np.random.default_rng(LM_SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, SSM_CHECK_SEQ + 1)),
                             device=DEVICE)
    mb = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    names = [n for n, _ in params.named_parameters()]
    plist = [p for _, p in params.named_parameters()]

    def grads_of(backend):
        loss = api.train_loss(cfg, params, mb, backend=backend)[0]
        return float(loss.detach()), torch.autograd.grad(loss, plist)

    _reset_counts()
    ref_loss, ref_g = grads_of("torch")
    _check_lm_launches("train_ssm step-0 reference", _read_counts(), 0,
                       launches)
    loss, g = grads_of(None)
    torch.cuda.synchronize()
    _check_lm_launches("train_ssm step-0 gradients", _read_counts(), 0,
                       launches, 2 * cfg.num_layers, cfg.num_layers)
    e = _step0_errors(names, loss, g, ref_loss, ref_g)
    bad = [f"{key} {e[key]:.3g} > {tol:g}" for key, tol in (
        ("loss_rel", SSM_LOSS_TOL), ("grad_norm_rel", SSM_GNORM_TOL),
        ("leaf_max", SSM_LEAF_TOL)) if not e[key] <= tol]
    check(not bad, f"train_ssm step 0 through wkv6 / wkv6_bwd against the "
          f"plain loop: {bad} (worst leaf {e['leaf_worst']})")
    del params, g, ref_g
    _release()
    return {"layers": cfg.num_layers, "seq": SSM_CHECK_SEQ,
            "dtype": "float32",
            **{k: v for k, v in e.items() if k != "leaf"}}


def _losses(steps) -> list:
    return [round(s["loss"], 3) for s in steps]


def _ssm_witness(launches: dict) -> dict:
    """The launcher's ``SSM_TRAIN_STEPS`` steps (its ``OptConfig``, data
    and seed) at ``SSM_CHECK_LAYERS`` layers, full width, bf16, on
    ``TRAIN_BATCH`` x ``SSM_WITNESS_SEQ`` tokens: through wkv6 / wkv6_bwd
    and through ``backend="torch"`` (the plain loop, differentiated by
    autograd) from the same weights; each step's loss and gradient norm,
    the losses held at ``SSM_WITNESS_TOL``."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, global_batch_at
    from repro_torch.dist import step as step_lib
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.optim import adamw
    cfg = _dense_cfg(SSM_ARCH, SSM_CHECK_LAYERS)
    shape = ShapeConfig("witness", SSM_WITNESS_SEQ, TRAIN_BATCH, "train")
    n_mb = step_lib.default_microbatches(shape)
    lr = train.build_args(["--arch", SSM_ARCH]).lr   # the launcher's
    opt = adamw.OptConfig(lr=lr, total_steps=SSM_TRAIN_STEPS,
                          warmup_steps=max(SSM_TRAIN_STEPS // 20, 1))
    runs = {}
    for backend in (None, "torch"):
        params = api.init_params(cfg, torch.Generator(
            device=DEVICE).manual_seed(LM_SEED), device=DEVICE)
        state = adamw.init_opt_state(params, step_lib.N_SHARDS)
        step = step_lib.build_train_step(
            cfg, params, opt, n_microbatches=n_mb,
            loss_fn=lambda p, mb, b=backend: api.train_loss(cfg, p, mb,
                                                            backend=b))
        _reset_counts()
        steps = []
        for i in range(SSM_TRAIN_STEPS):
            batch = global_batch_at(DataConfig(seed=LM_SEED), cfg, shape,
                                    n_mb, i, device=DEVICE)
            params, state, m = step(params, state, batch)
            steps.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                    "lr")})
        per = cfg.num_layers * n_mb * SSM_TRAIN_STEPS
        _check_lm_launches(f"train_ssm witness ({backend or 'kernels'})",
                           _read_counts(), 0, launches,
                           0 if backend else 2 * per, 0 if backend else per)
        runs[backend or "kernels"] = steps
        del params, state, step
        _release()
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
           for a, b in zip(runs["kernels"], runs["torch"])]
    check(all(np.isfinite(x["loss"]) for s in runs.values() for x in s)
          and max(rel) <= SSM_WITNESS_TOL,
          f"train_ssm witness: losses through the kernels "
          f"{[s['loss'] for s in runs['kernels']]} against the plain loop's "
          f"{[s['loss'] for s in runs['torch']]} (relative {rel})")
    return {"layers": cfg.num_layers, "dtype": str(cfg.dtype),
            "seq_len": SSM_WITNESS_SEQ, "global_batch": TRAIN_BATCH,
            "n_microbatches": n_mb, "lr": opt.lr,
            "warmup_steps": opt.warmup_steps, "steps": runs,
            "loss_rel": rel}


def phase_train_ssm(launches: dict) -> dict:
    """Phase 22 (the module docstring): wkv6_bwd alone at the training
    shape; step 0 at ``SSM_CHECK_LAYERS`` fp32 layers against the plain
    loop; then ``launch/train.py --arch rwkv6-3b --layers
    SSM_TRAIN_LAYERS`` at full width in bf16: run A trains
    ``SSM_TRAIN_STEPS`` steps with a checkpoint after step ``SSM_CKPT_AT``
    - 1, run B resumes from it in a fresh model for the rest, bit for bit
    equal to run A; wkv6 twice and wkv6_bwd once a layer and microbatch,
    B1-B5 never."""
    import os
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.step import default_microbatches
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    alone = _wkv6_bwd_alone()
    step0 = _ssm_step0_check(launches)
    witness = _ssm_witness(launches)
    cfg = _dense_cfg(SSM_ARCH, SSM_TRAIN_LAYERS)
    n_mb = default_microbatches(ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH,
                                            "train"))
    per_step = cfg.num_layers * n_mb
    base = ROOT / "build" / "chip_smoke_train_ssm"
    shutil.rmtree(base, ignore_errors=True)
    dir_a, dir_b = base / "a", base / "b"
    argv = ["--arch", SSM_ARCH, "--device", DEVICE, "--layers",
            str(SSM_TRAIN_LAYERS), "--seq-len", str(TRAIN_SEQ),
            "--global-batch", str(TRAIN_BATCH), "--steps",
            str(SSM_TRAIN_STEPS), "--log-every", "1", "--seed",
            str(LM_SEED), "--no-final-ckpt"]
    if DENSE_REDUCED:
        argv.append("--reduced")
    try:
        run_a = _train_cli(argv + ["--ckpt-every", str(SSM_CKPT_AT),
                                   "--ckpt-dir", str(dir_a)])
        _release()
        _check_lm_launches("train_ssm run A", run_a["launches"], 0,
                           launches, 2 * per_step * SSM_TRAIN_STEPS,
                           per_step * SSM_TRAIN_STEPS)
        ckpt = f"ckpt_{SSM_CKPT_AT:010d}.tensors"
        os.makedirs(dir_b)
        os.link(dir_a / ckpt, dir_b / ckpt)
        shutil.rmtree(dir_a)
        run_b = _train_cli(argv + ["--resume", "--ckpt-dir", str(dir_b)])
        _release()
        rest = SSM_TRAIN_STEPS - SSM_CKPT_AT
        _check_lm_launches("train_ssm run B", run_b["launches"], 0,
                           launches, 2 * per_step * rest, per_step * rest)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    check(run_b["start_step"] == SSM_CKPT_AT,
          f"train_ssm: resumed at {run_b['start_step']}")
    steps_a = run_a["steps"]
    for st in steps_a + run_b["steps"]:
        check(np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"]),
              f"train_ssm: step {st['step']} loss {st['loss']} grad_norm "
              f"{st['grad_norm']}")
    same = [(a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
            for a, b in zip(steps_a[SSM_CKPT_AT:], run_b["steps"])]
    check(len(same) == SSM_TRAIN_STEPS - SSM_CKPT_AT and all(same),
          f"train_ssm: resumed steps {run_b['steps']} differ from the "
          f"uninterrupted run's {steps_a[SSM_CKPT_AT:]}")
    for r in (run_a, run_b):
        check(r["peak_mem_gb"] < 80, f"train_ssm: peak "
              f"{r['peak_mem_gb']:.1f} GB")
    step_ms = [st["step_s"] * 1e3 for st in steps_a[1:]]
    med_s = statistics.median(step_ms) / 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6.0 * run_a["params"] * tokens
    rec = {"phase": "train_ssm",
           "nvidia_smi": RECORD["phases"][0].get("nvidia_smi"),
           "arch": SSM_ARCH, "layers": cfg.num_layers,
           "dtype": str(cfg.dtype), "seq_len": TRAIN_SEQ,
           "global_batch": TRAIN_BATCH, "n_microbatches": n_mb,
           "params": run_a["params"], "steps": steps_a,
           "resumed_steps": run_b["steps"], "resumed_equal_bitwise": all(same),
           "step_ms_steps_2_on": step_ms, "median_step_ms": med_s * 1e3,
           "tokens_per_s": tokens / med_s,
           "model_flops_share": flops / (med_s * PEAK_FLOPS["bfloat16"]),
           "model_flops_share_formula":
               "6 * params * tokens / (median step s * 989e12)",
           "peak_mem_gb": [run_a["peak_mem_gb"], run_b["peak_mem_gb"]],
           "ckpt_saves": run_a["ckpt"], "restore_s": run_b["restore_s"],
           "run_s": [run_a["wall_s"], run_b["wall_s"]],
           "launches_per_step": {"wkv6": 2 * per_step, "wkv6_bwd": per_step},
           "step0": step0, "witness": witness, "wkv6_bwd_alone": alone,
           "seconds": time.perf_counter() - t0}
    print(f"train_ssm {SSM_ARCH} at {cfg.num_layers} layers: median step "
          f"{rec['median_step_ms']:.1f} ms, {rec['tokens_per_s']:.0f} tok/s, "
          f"model-flops share {rec['model_flops_share']:.3f}, peak "
          f"{max(rec['peak_mem_gb']):.1f} GB; step 0 loss rel "
          f"{step0['loss_rel']:.2g}, worst leaf {step0['leaf_max']:.2g}; "
          f"witness losses {_losses(witness['steps']['kernels'])} (plain "
          f"loop {_losses(witness['steps']['torch'])}); "
          f"wkv6_bwd {alone['ms']:.3f} ms (bound {alone['bound_ms']:.3f}, "
          f"plain {alone['plain_ms']:.1f})", flush=True)
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 19: the production-mesh dry-run
# ---------------------------------------------------------------------------

# (arch, shape, mesh) traced by ``launch/dryrun.py`` on the card's machine.
DRYRUN_CELLS = (("llama3.2-1b", "train_4k", "single"),
                ("llama3.2-1b", "prefill_32k", "single"),
                ("llama3.2-1b", "decode_32k", "single"),
                ("qwen3-32b", "decode_32k", "multi"),
                ("qwen3-moe-30b-a3b", "decode_32k", "multi"),
                ("rwkv6-3b", "decode_32k", "multi"))
DRYRUN_LIMIT_S = 400

# One job of the dry-run, in a process of its own (the fake process group
# and FakeTensorMode stay out of this one): argv[2] names its cells and
# whether it runs spmm_dryrun and compress_bytes; it prints its results as
# one JSON object, with the kernels its process launched (none may).
_DRYRUN_DRIVER = """
import json, sys, time
t0 = time.time()
from repro_torch.benchmarks import compress_bytes, spmm_dryrun
from repro_torch.kernels import (bcsr_spmm, csr_spmm, flash_attention,
                                 spmm_sdd, wkv6)
from repro_torch.launch import dryrun
out_dir, job = sys.argv[1], json.loads(sys.argv[2])
res = {"import_s": time.time() - t0, "lines": []}
res["cells"] = [dryrun.run_cell(a, s, m, device="cuda", out_dir=out_dir)
                for a, s, m in job["cells"]]
if job["suites"]:
    t0 = time.time()
    res["spmm"] = spmm_dryrun.main(["--device", "cuda", "--out", out_dir],
                                   out=res["lines"].append)
    res["spmm_s"] = time.time() - t0
    t0 = time.time()
    res["compress"] = compress_bytes.main(out=res["lines"].append)
    res["compress_s"] = time.time() - t0
res["launches"] = sum(f.launches for f in (
    csr_spmm.csr_panels_spmm, bcsr_spmm.bcsr_panels_spmm,
    spmm_sdd.csr_sdd_panels, spmm_sdd.bcsr_sdd_panels,
    flash_attention.flash_attention, wkv6.wkv6, wkv6.wkv6_bwd))
print(json.dumps(res))
"""


def phase_dryrun(work_dir) -> dict:
    """Phase 19 (the module docstring): ``launch/dryrun.py``'s cells of
    ``DRYRUN_CELLS``, ``benchmarks/spmm_dryrun.py`` at full size and
    ``benchmarks/compress_bytes.py``, traced on fake CUDA tensors over a
    fake process group, in three processes at once (the train cell; the
    other cells; the two suites); every cell must end ``ok``, and nothing
    may launch."""
    import math
    import os
    from repro_torch.benchmarks import roofline
    from repro_torch.benchmarks._util import PEAK_FLOPS_F32, PEAKS_SOURCE
    from repro_torch.configs import SHAPES, get_config
    out_dir = pathlib.Path(work_dir) / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    jobs = [{"cells": DRYRUN_CELLS[:1], "suites": False},
            {"cells": DRYRUN_CELLS[1:], "suites": False},
            {"cells": (), "suites": True}]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-W", "ignore::FutureWarning", "-c", _DRYRUN_DRIVER,
         str(out_dir), json.dumps(job)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for job in jobs]
    outs = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(
                timeout=max(1.0, DRYRUN_LIMIT_S - (time.perf_counter() - t0)))
            check(proc.returncode == 0, f"dryrun exited {proc.returncode}: "
                  f"{stdout[-2000:]} {stderr[-3000:]}")
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.perf_counter() - t0
    res = {**outs[2], "cells": [c for o in outs for c in o["cells"]],
           "launches": sum(o["launches"] for o in outs),
           "import_s": [o["import_s"] for o in outs]}
    check(res["launches"] == 0, f"dryrun: the fake trace launched "
          f"{res['launches']} kernels")
    cells = []
    for rec in res["cells"]:
        name = f"{rec['arch']} {rec['shape']} {rec['mesh']}"
        check(rec["status"] == "ok", f"dryrun {name}: {rec.get('error')} "
              f"{rec.get('traceback', '')[-1500:]}")
        h = rec["hlo"]
        check(h["flops_per_device"] > 0 and h["hbm_bytes_per_device"] > 0,
              f"dryrun {name}: counted nothing ({h})")
        if SHAPES[rec["shape"]].kind == "train":
            check({"all-reduce", "reduce-scatter"} <= set(
                h["collective_by_kind"]), f"dryrun {name}: the step's "
                f"collectives are {sorted(h['collective_by_kind'])}")
        terms = roofline.terms(rec)
        cells.append({
            "cell": name, "mesh_shape": rec["mesh_shape"],
            "n_microbatches": rec["n_microbatches"],
            "flops": h["flops_per_device"], "hbm_bytes":
            h["hbm_bytes_per_device"], "collective_bytes":
            h["collective_bytes_per_device"], "collective_by_kind":
            h["collective_by_kind"], "ops": h["n_ops"],
            "memory": rec["memory_analysis"], "terms_s": terms,
            "dominant": max(terms, key=terms.get),
            "model_flops_per_device": roofline.model_flops(
                get_config(rec["arch"]), SHAPES[rec["shape"]])
            / math.prod(rec["mesh_shape"].values()),
            "trace_s": rec["trace_s"]})
    spmm = res["spmm"]
    check(spmm["status"] == "ok", f"spmm_dryrun: {spmm}")
    for group, r in spmm["ranks"].items():
        lanes = r["nnz"] if group == "csr" else r["tiles"] * 8
        check(r["hlo"]["flops_per_device"] == 2 * lanes * 32,
              f"spmm_dryrun {group} rank {r['rank']}: "
              f"{r['hlo']['flops_per_device']} flops, its chunk needs "
              f"2 x {lanes} x 32")
    comp = res["compress"]
    check(comp["int8"] * 3 <= comp["fp32"] and
          1.9 <= comp["fp32"] / comp["bf16"] <= 2.1,
          f"compress_bytes: {comp}")
    rec = {"phase": "dryrun", "peaks": PEAKS_SOURCE,
           "nvidia_smi": RECORD["phases"][0].get("nvidia_smi"),
           "cells": cells,
           "spmm": {"ranks": spmm["ranks"], "overrides": spmm["overrides"],
                    "hlo": spmm["hlo"], "terms_s": roofline.terms(
                        spmm, PEAK_FLOPS_F32), "trace_s": spmm["trace_s"],
                    "s": res["spmm_s"]},
           "compress_bytes": comp, "compress_s": res["compress_s"],
           "import_s": res["import_s"], "seconds": seconds}
    phase(rec)
    return rec


# ---------------------------------------------------------------------------

SOURCES = {
    "csr_panels_spmm": ("src/repro_torch/csrc/csr_spmm.cu",
                        "src/repro/kernels/csr_spmm.py:172"),
    "bcsr_panels_spmm": ("src/repro_torch/csrc/bcsr_spmm.cu",
                         "src/repro/kernels/bcsr_spmm.py:177"),
    "csr_sdd_panels": ("src/repro_torch/csrc/csr_sdd.cu",
                       "src/repro/kernels/spmm_sdd.py:164"),
    "bcsr_sdd_panels": ("src/repro_torch/csrc/bcsr_sdd.cu",
                        "src/repro/kernels/spmm_sdd.py:336"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:82"),
    "wkv6": ("src/repro_torch/csrc/wkv6.cu",
             "src/repro/models/rwkv6.py:90 _wkv_scan"),
    "wkv6_bwd": ("src/repro_torch/csrc/wkv6.cu",
                 "the XLA derivative of src/repro/models/rwkv6.py:90 "
                 "_wkv_scan"),
}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="directory to write the full record into, as "
                         "chip_smoke.json, and phases 4 and 9's obs "
                         "captures beside it")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU "
              "path only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from a checkout of the repository (no "
              "src/repro_torch next to this script)", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    env = phase_env()
    phase_kernels()
    launches = {k: 0 for k in KERNELS}
    main_recs = phase_main(launches)
    # The plan caches of phases 4 and 9 (and their captures without --out)
    # live in a directory removed at exit.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        phase_tune(launches, args.out, work)
        phase_gcn(launches)
        phase_train_gcn(launches)
        ffn_recs = phase_train_ffn(launches)
        lm_rec = phase_serve_lm(launches)
        phase_serve_obs(launches, lm_rec, args.out, work)
        phase_serve_traffic(launches)
        phase_operator_bench(launches, args.out)
        phase_train_lm(launches)
        phase_fallback(launches)
        phase_gcn_example(launches, work)
        phase_table3(launches)
        phase_distributed(launches, work)
        phase_train_mesh(launches, work)
        phase_serve_dense(launches)
        phase_serve_moe(launches)
        ssm_rec = phase_serve_ssm(launches)
        ssm_train = phase_train_ssm(launches)
        phase_dryrun(work)
    for k, v in launches.items():
        check(v > 0, f"{k} never launched on the port's paths")

    # The kernels line reports B1/B2 at the pwtk (m6) fp32 main-path call,
    # B3/B4 at the fp32 sparse-FFN backward, B5 at the bf16 serving shape,
    # wkv6 at rwkv6-3b's serving prefill and wkv6_bwd at its training
    # microbatch.
    rep = next(r for r in main_recs
               if r["matrix"] == "m6" and r["dtype"] == "float32")
    rep_ffn = next(r for r in ffn_recs if r["dtype"] == "float32")
    line = []
    for name, (src, replaces) in SOURCES.items():
        if name == "flash_attention":
            k = lm_rec["b5_alone"]
        elif name == "wkv6":
            k = ssm_rec["wkv6_alone"]
        elif name == "wkv6_bwd":
            k = ssm_train["wkv6_bwd_alone"]
        else:
            k = (rep if name.endswith("spmm") else rep_ffn)["kernels"][name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    RECORD["kernels"] = line
    RECORD["total_s"] = time.perf_counter() - t_start
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(RECORD,
                                                             indent=1))
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                 "count": env["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
