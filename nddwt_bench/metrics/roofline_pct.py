"""The work's share of the roofline over the device's busy time, in %: the
least time the chip could take for the window's units (the larger of the
bytes they need over the memory bandwidth and their operations over the
float32 peak, counted from shapes by the traffic's kind, whatever kernels
carry them out) over the time in which anything ran on the device. The
bound that sets the least time goes into the line's notes."""


def read(rec):
    if rec.trace is None or rec.peaks is None or rec.trace.busy_s <= 0 or not rec.units:
        return None
    least, bound = rec.work.least_s(rec.peaks)
    rec.notes[f"{rec.metric} bound"] = bound
    return 100.0 * least * rec.units / rec.trace.busy_s
