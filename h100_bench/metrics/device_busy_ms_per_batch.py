"""The union of the device's operations inside each batch, in ms, averaged
over the traced batches."""


def read(run):
    t = run.trace
    if t is None or not t.batch_busy_s or not any(t.batch_busy_s):
        return None
    return 1e3 * sum(t.batch_busy_s) / len(t.batch_busy_s)
