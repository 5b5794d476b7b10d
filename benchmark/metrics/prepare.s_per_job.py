"""``engine.run.prepare`` (feed, index load, refstats): host seconds a
job, from the benchmark's clock around the call."""


def read(obs):
    s = obs["phase_s"].get("prepare")
    return None if s is None else s / len(obs["jobs"])
