"""The non-fresh state import: the port's ``state_walk`` span, the
walk over every read's state object that each (database, part, batch)
unit after the first makes to take up what earlier units left, a
million read nucleotides."""


def read(obs):
    t = obs["timers"]
    if "state_walk" not in t:
        return None
    return t["state_walk"][0] / obs["mnt"]
