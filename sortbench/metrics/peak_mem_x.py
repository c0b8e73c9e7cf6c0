"""``peak_mem_x`` (x): the largest number of device bytes a call held at
once above those held before it, over the call's input bytes (keys and
values), taken over every call of the timed window."""


def read(run):
    peaks = run.window.peaks
    if not peaks:
        return None
    return max(peaks) / run.input_bytes
