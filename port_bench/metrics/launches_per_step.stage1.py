"""launches_per_step.stage1: device kernels a step in the profiled
window."""


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("steps") or "hash_bound_s" not in t:
        return None
    return len(t["kernels"]) / t["steps"]
