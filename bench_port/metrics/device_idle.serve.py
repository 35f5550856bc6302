"""The device: the share of the traced stretch in which no operation
(kernel, copy, set) runs on it, from the union of their intervals."""


def read(view):
    t = view.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 and t.busy_s > 0 else None
