"""Consumers of the LOOPS SpMM: the §4.5 GCN."""
from .gcn import GCN, gcn_params_from_numpy

__all__ = ["GCN", "gcn_params_from_numpy"]
