"""The share of the SW jobs the card scored whose result a read's FSM
applied, in %: the native engine's ``sw_jobs_consumed`` over
``sw_jobs_scored`` (the count slots of the port's stage timers).  The
rest is speculative work that no read used."""


def read(obs):
    t = obs["timers"]
    scored = t.get("sw_jobs_scored", [0.0, 0])[1]
    if scored <= 0:
        return None
    return 100.0 * t.get("sw_jobs_consumed", [0.0, 0])[1] / scored
