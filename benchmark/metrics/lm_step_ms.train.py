"""Host ms a step in ``gpt_trainer.train_step`` (the LM's forward and
backward with K4-K6, the clip and AdamW), from a synchronised span around
the call."""


def read(rec):
    if rec["kind"] != "gpttrain" or not rec["spans"].get("lm_step"):
        return None
    return sum(rec["spans"]["lm_step"]) / rec["units"] * 1e3
