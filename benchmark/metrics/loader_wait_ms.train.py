"""Host ms a step the training loop waits in the loader's ``next()``."""


def read(rec):
    if rec["kind"] != "gpttrain" or not rec["spans"].get("loader_wait"):
        return None
    return sum(rec["spans"]["loader_wait"]) / rec["units"] * 1e3
