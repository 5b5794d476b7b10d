"""The job wall outside the four ``run_all`` phases (StateDB saves, the
summary, CLI parsing): seconds a million read nucleotides."""

PHASES = ("prepare", "run_align", "run_postprocess", "run_reports")


def read(obs):
    p = obs["phase_s"]
    if not all(k in p for k in PHASES):
        return None
    wall = sum(j["wall"] for j in obs["jobs"])
    return (wall - sum(p[k] for k in PHASES)) / obs["mnt"]
