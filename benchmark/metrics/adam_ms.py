"""adam_ms (layer: optimizer): host time of the program's ``adam`` spans
(the learning rate, clipping where there is any, the moment and parameter
updates) of a train step, mean per ``step`` root."""
from benchmark.spans import program_spans


def read(run):
    spans = program_spans(run)
    steps = sum(1 for s in spans if s[0] == "step")
    total = sum(t1 - t0 for label, t0, t1 in spans if label == "adam")
    return total * 1e3 / steps if steps and total > 0 else None
