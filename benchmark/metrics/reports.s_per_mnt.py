"""``engine.run.run_postprocess`` and ``run_reports``: host seconds a
million read nucleotides, from the benchmark's clock."""


def read(obs):
    p = obs["phase_s"]
    if "run_postprocess" not in p or "run_reports" not in p:
        return None
    return (p["run_postprocess"] + p["run_reports"]) / obs["mnt"]
