"""The card's idle share of the traced window, in %: one minus the
union of the device operations' intervals (kernels, copies, sets) over
the window, from the profiler's trace."""


def read(obs):
    d = obs["device"]
    if not d or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
