"""Host ms a rollout in ``rollout.detokenize`` (both decoders, in chunks),
from a synchronised span around the call."""


def read(rec):
    if rec["kind"] != "rollout" or not rec["spans"].get("detokenize"):
        return None
    return sum(rec["spans"]["detokenize"]) / rec["units"] * 1e3
