"""The whole rollout's share of the card's peak, %: the least time of its
model FLOPs (the encoder, the prefill, every decode step and the render at
the bf16 peak, the VQ distances at the fp32 peak:
``roofline.rollout_flop_seconds``) over the host seconds a rollout took in
the window."""

from benchmark import roofline


def read(rec):
    if rec["kind"] != "rollout" or not rec["units"]:
        return None
    least = roofline.rollout_flop_seconds(rec["cfg"], rec["traffic"]["batch"])
    return 100.0 * least * rec["units"] / rec["window_s"]
