"""K3's share of its roofline, %, over the traced rollout: the least time
of every decode step's attention over the int8 cache (bytes at the HBM
rate or operations at the bf16 peak, ``roofline.k3_rollout_bound_s``) over
the device seconds of the kernels named ``decode_attn``."""

from benchmark import roofline


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "rollout" or t is None:
        return None
    busy = t.seconds_of("decode_attn")
    if not busy:
        return None
    bound = roofline.k3_rollout_bound_s(rec["cfg"], rec["traffic"]["batch"])
    return 100.0 * bound * t.units / busy
