"""``records_per_s`` (Mrecords/s): every record sorted in the timed window
over all of the window's seconds, the gaps between calls included."""


def read(run):
    w = run.window
    return len(w.walls) * run.records / w.seconds / 1e6
