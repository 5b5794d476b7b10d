"""The job's state saves: the port's ``state_save`` (each StateDB
``save_states`` and ``save_readstats`` pair) and ``journal_append``
(each align-journal record) spans, a million read nucleotides."""


def read(obs):
    t = obs["timers"]
    if "state_save" not in t:
        return None
    return sum(t[k][0] for k in ("state_save", "journal_append")
               if k in t) / obs["mnt"]
