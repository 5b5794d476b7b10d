"""The share of the acquisitions of a part's references that mapped
them from the part's sidecar in the index directory, in %: the port's
``ref_mapped`` over ``ref_mapped`` plus ``ref_parsed`` (count slots of
its stage timers, one an acquisition, in the align pass and the report
sweeps).  The rest parsed the database's FASTA.  None where neither was
counted, as in a port that parses the references in every job."""


def read(obs):
    t = obs["timers"]
    mapped = t.get("ref_mapped", [0.0, 0])[1]
    total = mapped + t.get("ref_parsed", [0.0, 0])[1]
    if total <= 0:
        return None
    return 100.0 * mapped / total
