"""``host_reads_per_sort`` (count): the program's own count of the sort
loop's device-to-host reads over the traced window, per call."""


def read(run):
    t = run.traced
    return t.counts["host_reads"] / t.trace.n_calls
