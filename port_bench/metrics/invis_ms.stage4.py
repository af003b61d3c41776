"""invis_ms.stage4: device ms an iteration of the kernels launched under
Stage4Runner._invis_step (select_topk, K3 / K4, the second Adam step) in
the profiled window; nothing where the traffic has no generated views."""


def read(rec):
    t = rec.get("trace")
    if not t or "under" not in t or not t.get("steps"):
        return None
    s = t["under"].get("bench.invis", 0.0)
    return s / t["steps"] * 1e3 if s > 0 else None
