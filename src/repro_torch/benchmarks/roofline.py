"""§Roofline: per (arch x shape) three-term roofline from the dry-run's
records (single-pod mesh).

Port of the reference's ``benchmarks/roofline.py``, with one H100's
published peaks (``_util.py``) in place of the TPU's:

  compute term    = flops_per_device / peak FLOP/s (bf16 for the LMs,
                    fp32 for the LOOPS cell)
  memory term     = hbm_bytes_per_device / HBM bytes/s
  collective term = collective_bytes_per_device / NVLink bytes/s a
                    direction

The per-device counts are ``perf/hlo_analysis.py``'s over one rank's
traced step (``launch/dryrun.py``), so "/ chips" is already applied.
MODEL_FLOPS uses 6*N*D for training cells and 2*N*D for inference cells
(N = active params).  These are bounds from a trace, not measurements:
each line names the peaks it divides by and the card (name and power
limit) of the machine that printed it.  Writes ``roofline.md`` beside the
records, plus CSV rows.
"""
from __future__ import annotations

import json
import pathlib

from ..configs import SHAPES, get_config
from ..launch.dryrun import RESULTS_DIR
from ._util import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32,
                    PEAKS_SOURCE, card_label, csv_row)

__all__ = ["active_params", "model_flops", "terms",
           "load_cells", "main"]


def active_params(cfg) -> float:
    """Analytic active-parameter count (the reference's; MoE: top_k of the
    routed experts)."""
    d, L = cfg.d_model, cfg.num_layers
    hd = cfg.resolved_head_dim
    attn = d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
    if cfg.family == "moe":
        ffn = 3 * d * cfg.moe_d_ff * cfg.top_k
        if cfg.num_shared_experts:
            ffn += 3 * d * cfg.d_ff + d  # shared expert + gate
        ffn += d * cfg.num_experts  # router
    elif cfg.family == "ssm":
        attn = 5 * d * d + 2 * d * 32 * 5  # rwkv time-mix proj + lora approx
        ffn = d * cfg.d_ff * 2 + d * d
    else:
        ffn = 3 * d * cfg.d_ff if cfg.act == "swiglu" else 2 * d * cfg.d_ff
    if cfg.family == "hybrid":
        attn += 2 * d * d + 2 * d * cfg.ssm_state + d * d  # mamba head
    emb = cfg.vocab_padded() * d * (1 if cfg.tie_embeddings else 2)
    total = L * (attn + ffn) + emb
    if cfg.family == "audio":
        total += (cfg.encoder_layers or L) * (attn + 2 * d * cfg.d_ff)
    return float(total)


def model_flops(cfg, shape) -> float:
    n = active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens


def terms(rec: dict, peak: float = PEAK_FLOPS_BF16) -> dict:
    """A record's three terms in seconds (compute against ``peak``)."""
    h = rec["hlo"]
    return {"compute": h["flops_per_device"] / peak,
            "memory": h["hbm_bytes_per_device"] / HBM_BW,
            "collective": h["collective_bytes_per_device"] / NVLINK_BW}


def advice(dom: str, shape_kind: str) -> str:
    if dom == "compute":
        return ("near roofline already; next wins are kernel-level (B5's "
                "backward as a kernel, tensor-core occupancy)")
    if dom == "memory":
        if shape_kind == "decode":
            return ("decode is weight/cache-bandwidth bound: narrower KV "
                    "cache and weights, or more requests per card")
        return ("reduce HBM traffic: less remat recompute, fewer fp32 "
                "widenings, fused elementwise passes")
    return ("collective-bound: overlap the reduce-scatter with microbatch "
            "compute, compressed gradients, or a reshard")


def load_cells(mesh="single", tag="", results=None):
    results = results or RESULTS_DIR
    suffix = f"__{mesh}__{tag}.json" if tag else f"__{mesh}.json"
    cells = []
    for path in sorted(pathlib.Path(results).glob(f"*{suffix}")):
        rec = json.loads(path.read_text())
        if rec.get("status") == "ok":
            cells.append(rec)
    return cells


def main(out=print, tag: str = "", results=None):
    results = results or RESULTS_DIR
    cells = load_cells("single", tag, results)
    card = card_label()
    lines = [f"# Roofline (single-pod 16x16; {PEAKS_SOURCE}; printed on: "
             f"{card})", "",
             "| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | "
             "dominant | roofline frac | MODEL/traced flops | note |",
             "|---|---|---|---|---|---|---|---|---|"]
    for rec in cells:
        chips = 1
        for v in rec["mesh_shape"].values():
            chips *= int(v)
        h = rec["hlo"]
        if rec["arch"].startswith("loops-spmm"):
            # the paper's operator: useful flops = 2 * nnz * N, in fp32
            nnz = rec.get("overrides", {}).get("nnz", 0)
            ncols = int(rec["shape"].split("_n")[-1])
            t = terms(rec, PEAK_FLOPS_F32)
            dom = max(t, key=t.get)
            t_step = max(t.values())
            t_useful = 2.0 * nnz * ncols / chips / PEAK_FLOPS_F32
            lines.append(
                f"| {rec['arch']} | {rec['shape']} | {t_useful:.3e} | "
                f"{t['memory']:.3e} | {t['collective']:.3e} | {dom} | "
                f"{t_useful / t_step if t_step else 0:.3f} | n/a | "
                f"the paper's operator over {chips} ranks (B1 on the CSR "
                f"group, B2 on the BCSR group), fp32 peak |")
            out(csv_row(f"roofline_{rec['arch']}_{rec['shape']}",
                        t_step * 1e6, f"dom={dom};useful_t={t_useful:.2e};"
                        f"card={card}"))
            continue
        cfg = get_config(rec["arch"])
        shape = SHAPES[rec["shape"]]
        t = terms(rec)
        dom = max(t, key=t.get)
        t_step = max(t.values())
        frac = t["compute"] / t_step if t_step > 0 else 0.0
        mf = model_flops(cfg, shape)
        ratio = mf / max(h["flops_per_device"] * chips, 1.0)
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | {t['compute']:.3e} | "
            f"{t['memory']:.3e} | {t['collective']:.3e} | {dom} | "
            f"{frac:.3f} | {ratio:.3f} | {advice(dom, shape.kind)} |")
        out(csv_row(f"roofline_{rec['arch']}_{rec['shape']}", t_step * 1e6,
                    f"dom={dom};frac={frac:.3f};model_traced_ratio="
                    f"{ratio:.3f};card={card}"))
    path = pathlib.Path(results) / "roofline.md"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    out(csv_row("roofline_table_written", 0.0, str(path)))


if __name__ == "__main__":
    main()
