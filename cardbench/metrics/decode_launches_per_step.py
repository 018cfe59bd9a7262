"""Device operations launched inside the benchmark's decode ranges of the
traced sub-window, per decode step."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "serve" or not tr or not tr["info"]["decode_steps"]:
        return None
    got = tr["by_range"].get("decode")
    if not got:
        return None
    return got["launches"] / tr["info"]["decode_steps"]
