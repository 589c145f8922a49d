"""mfu.serve: the model FLOPs of the requests served (harness.flops.request
at their actual rows) over the summed wall of their predict calls times
the card's dense bf16 peak, in %.  It divides by service time, not by the
window, because the offered rate is fixed."""

from harness import flops, peaks


def read(run):
    busy = sum(end - start for _, start, end, _ in run.requests)
    if busy <= 0:
        return None
    work = sum(flops.request(run.config, rows) for _, _, _, rows in run.requests)
    return 100.0 * work / (busy * peaks.MFU_PEAK)
