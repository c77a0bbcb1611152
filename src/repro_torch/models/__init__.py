"""Models of the port: the consumers of the LOOPS SpMM (the §4.5 GCN and
the weight-sparse linear layer, both trainable through the CUDA kernels)
and the dense LM (``layers``, ``transformer``, ``api``), served with its
prefill attention on the CUDA kernel B5."""
from .gcn import GCN, gcn_loss, gcn_params_from_numpy, sgd_step
from .sparse_ffn import (SparseLinear, magnitude_prune,
                         sparse_linear_apply, sparse_linear_from_dense,
                         sparse_linear_from_numpy)

__all__ = ["GCN", "gcn_loss", "gcn_params_from_numpy", "sgd_step",
           "SparseLinear", "magnitude_prune", "sparse_linear_apply",
           "sparse_linear_from_dense", "sparse_linear_from_numpy"]
