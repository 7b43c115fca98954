"""Host ms a rollout in its tokenize stage: the context encode (K1) and the
prelude, from synchronised spans around the calls rollout.rollout
makes."""


def read(rec):
    if rec["kind"] != "rollout" or not rec["spans"].get("tokenize"):
        return None
    return sum(rec["spans"]["tokenize"]) / rec["units"] * 1e3
