"""The native part driver's own host stages (seed search, LIS, FSMs):
the port's spans ``trav_pump``, ``fsm_jobs``, ``fsm_post``,
``fsm_apply``, ``batch_enc``, ``state_import`` and ``engine_init``,
summed over their threads, a million read nucleotides.  Unlike the
``part_driver`` span, it leaves out the SW submits, the waits on the
card and the tracebacks that the part driver encloses."""

STAGES = ("trav_pump", "fsm_jobs", "fsm_post", "fsm_apply", "batch_enc",
          "state_import", "engine_init")


def read(obs):
    t = obs["timers"]
    if "trav_pump" not in t:
        return None
    return sum(t[k][0] for k in STAGES if k in t) / obs["mnt"]
