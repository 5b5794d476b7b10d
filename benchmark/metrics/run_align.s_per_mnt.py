"""``engine.run.run_align`` (part driver, SW waves, traceback): host
seconds a million read nucleotides, from the benchmark's clock."""


def read(obs):
    s = obs["phase_s"].get("run_align")
    return None if s is None else s / obs["mnt"]
