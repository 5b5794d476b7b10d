"""The native part driver (host seed search, LIS, FSMs): the port's
``part_driver`` stage timer, summed over its threads, a million read
nucleotides."""


def read(obs):
    t = obs["timers"].get("part_driver")
    return None if t is None else t[0] / obs["mnt"]
