"""Host ms a step in the frozen fp32 tokenize (both encoders, K1 twice), from
a synchronised span around the call."""


def read(rec):
    if rec["kind"] != "gpttrain" or not rec["spans"].get("tokenize"):
        return None
    return sum(rec["spans"]["tokenize"]) / rec["units"] * 1e3
