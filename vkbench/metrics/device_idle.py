"""% of an item's wall time (a frame served, a train step) in which no
kernel, copy or set runs on the device: 1 - (device busy time an item
under the profiler, the union of kernel, copy and set intervals) / (wall
time an item with the profiler off, from the first half of the traced
run). The profiler slows the host, not the device, so its own wall time
would overstate the idle share."""

from vkbench import trace


def read(rec):
    busy = trace.busy_s(rec["events"])
    if busy <= 0 or not rec["plain_items"]:
        return None
    return 100.0 * (1.0 - (busy / rec["profiled_items"]) / (rec["plain_s"] / rec["plain_items"]))
