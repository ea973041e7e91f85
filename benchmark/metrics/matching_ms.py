"""matching_ms (layer: matching engine): host wall of the session's
``match_instances`` per FG command (backbone on a new image, the RMI
fusion, the threshold and the per-instance occupancy, which ends in a
device-to-host copy), from the benchmark's span around the call."""


def read(run):
    spans = [t1 - t0 for label, t0, t1 in run.spans
             if label == "match_instances"]
    return sum(spans) * 1e3 / len(spans) if spans else None
