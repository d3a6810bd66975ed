"""commit_s (host plan, host clock): the seconds of every ``commit`` of the
cell's plans in set-up, summed."""


def read(run):
    return sum(run.commit_s)
