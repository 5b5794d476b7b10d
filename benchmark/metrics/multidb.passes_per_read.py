"""Database passes a read took: the port's count ``db_reads_searched``
(the reads that enter a (database, part, batch) unit not done and at
least the seed window long, each once, not once a strand) over the
window's reads, both mates counted.  Between 0 and the number of
databases; the later reads align, the higher."""


def read(obs):
    t = obs["timers"]
    if "db_reads_searched" not in t or obs["reads"] <= 0:
        return None
    return t["db_reads_searched"][1] / obs["reads"]
