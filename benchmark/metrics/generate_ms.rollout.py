"""Host ms a rollout in ``generation.generate`` (the K4 prefill, then every
decode step from Python: the LLaMA layers, K3, the top-k search and the
draw), from a synchronised span around the call."""


def read(rec):
    if rec["kind"] != "rollout" or not rec["spans"].get("generate"):
        return None
    return sum(rec["spans"]["generate"]) / rec["units"] * 1e3
