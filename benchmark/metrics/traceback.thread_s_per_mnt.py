"""The host banded traceback (``run.materialize_cigars_for``): the
port's ``cigar_mat`` stage timer, summed over threads, a million read
nucleotides."""


def read(obs):
    t = obs["timers"].get("cigar_mat")
    return None if t is None else t[0] / obs["mnt"]
