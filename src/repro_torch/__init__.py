"""repro_torch: the LOOPS hybrid SpMM on PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The port of the JAX/Pallas package ``repro`` (which stays as the reference
and is never imported here).  Its layout mirrors ``repro``'s, so every
ported file has a twin at the same relative path:

  * ``core``: formats (Algorithm 1, device residency), partition (Eq. 1),
    perf_model (Eq. 2/3), suite (synthetic Table-2 matrices), spmm (the
    front door);
  * ``kernels``: the CUDA kernels B1 (``csr_spmm``) and B2 (``bcsr_spmm``)
    of the product and B3/B4 (``spmm_sdd``) of its value gradient, with
    their plain PyTorch versions, the flat references and the engine;
  * ``resilience``: validated ingestion;
  * ``models``: the §4.5 GCN and the weight-sparse linear layer, both
    trainable.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
