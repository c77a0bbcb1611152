"""repro_torch: the LOOPS hybrid SpMM and a dense LM (served and trained)
on PyTorch and hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of the JAX/Pallas package ``repro`` (which stays as the reference
and is never imported here).  Its layout mirrors ``repro``'s, so every
ported file has a twin at the same relative path:

  * ``core``: formats (Algorithm 1, device residency), partition (Eq. 1),
    perf_model (Eq. 2/3), suite (synthetic Table-2 matrices), spmm (the
    front door);
  * ``kernels``: the CUDA kernels B1 (``csr_spmm``) and B2 (``bcsr_spmm``)
    of the product, B3/B4 (``spmm_sdd``) of its value gradient and B5
    (``flash_attention``) of the LM's prefill and training attention, with
    their plain PyTorch versions, the flat references and the engine;
  * ``tune``, ``perf``, ``obs`` and ``resilience``: the plan layer -- the
    autotuner and its plan cache, perf traces and replay, runtime metrics
    and spans, validated ingestion, fault injection and retries;
  * ``models``: the §4.5 GCN and the weight-sparse linear layer, both
    trainable, and the dense LM (``layers``, ``transformer``, ``api``),
    trainable too;
  * ``configs``: the dense architectures (llama3.2-1b and its reduced
    twin) and the input-shape cells;
  * ``serve``, ``dist`` and ``launch.serve``: the continuous-batching
    queue, its executor pool of static-buffer steps (CUDA graphs per shape
    bucket on the card) and its command line;
  * ``optim``, ``data``, ``checkpoint``, ``dist.step.build_train_step``
    and ``launch.train``: LM training (flat AdamW, the seeded token stream,
    async step-atomic checkpoints, the grad-accumulating step, the
    command line);
  * ``benchmarks``: the paper's operator evaluation and the closed-loop
    serving load (``serve_traffic``).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
