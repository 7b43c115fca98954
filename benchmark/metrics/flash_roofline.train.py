"""K4-K6's share of their roofline, %, over the traced steps: the least
time of every layer's causal attention forward, dK/dV and dQ (each the
larger of its bytes at the HBM rate and its FLOP at the bf16 peak, no term
for drawing the dropout mask: ``roofline.flash_step_bound_s``) over the
device seconds of the kernels named ``flash_fwd`` or ``flash_bwd``."""

from benchmark import roofline
from benchmark.reference.params import tok_dims


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "gpttrain" or t is None:
        return None
    busy = t.seconds_of("flash_fwd", "flash_bwd")
    if not busy:
        return None
    cfg = rec["cfg"]
    d = tok_dims(cfg["tokenizer"])
    ctx, seg = cfg["context_length"], cfg["segment_length"]
    S = (d["ctx_tokens"] + 1) * ctx - 1 + (seg - ctx) * (d["dyn_tokens"] + 1)
    bound = roofline.flash_step_bound_s(cfg, rec["traffic"]["batch"], S)
    return 100.0 * bound * t.units / busy
