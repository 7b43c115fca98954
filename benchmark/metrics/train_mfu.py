"""The whole training step's share of the card's peak, %: the least time
of its model FLOPs (the frozen tokenize's encoders and VQ distances at the
fp32 peak, the LM's forward and backward at the bf16 peak:
``roofline.train_step_flop_seconds``) over the host seconds a step took in
the window, the loader's wait included."""

from benchmark import roofline


def read(rec):
    if rec["kind"] != "gpttrain" or not rec["units"]:
        return None
    least = roofline.train_step_flop_seconds(rec["cfg"],
                                             rec["traffic"]["batch"])
    return 100.0 * least * rec["units"] / rec["window_s"]
