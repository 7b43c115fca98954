"""The device's idle share, %, over the traced rollout: 1 - (the union of
its kernels' intervals) / (the traced stretch's host seconds)."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "rollout" or t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
