"""host_ms.stage4: mean host ms an iteration inside the harness's spans
around training/stage4.py's Stage4Runner._rebin, _step and _invis_step over
the window."""


def read(rec):
    w, spans = rec.get("window"), rec.get("spans")
    if not w or spans is None or not w["steps"] \
            or not spans.count("step", since=w["t0"]):
        return None
    total = sum(spans.total_s(n, since=w["t0"])
                for n in ("rebin", "step", "invis"))
    return total / w["steps"] * 1e3
