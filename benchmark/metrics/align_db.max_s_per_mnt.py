"""The database pass that sets the pace: the largest of the port's
``align_db[<i>]`` spans (one a database's pass of ``run_align``, every
part and batch of it, summed over the window's jobs), a million read
nucleotides."""


def read(obs):
    passes = [v[0] for k, v in obs["timers"].items()
              if k.startswith("align_db[")]
    if not passes:
        return None
    return max(passes) / obs["mnt"]
