"""Getting a part's references: the port's ``ref_load`` span (every
acquisition of a part's references, mapped or parsed, in the align pass
and the report sweeps, summed over the window's jobs), a million read
nucleotides."""


def read(obs):
    t = obs["timers"]
    if "ref_load" not in t:
        return None
    return t["ref_load"][0] / obs["mnt"]
