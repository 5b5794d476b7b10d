"""The host blocked on the card: the port's ``sw_wait`` span, around
each SW block's ``synchronize`` at its fetch, summed over threads, a
million read nucleotides."""


def read(obs):
    t = obs["timers"].get("sw_wait")
    return None if t is None else t[0] / obs["mnt"]
