"""Mean, over the run's jobs, of the mean NMI of each job's final
partitions to the planted labels (``reference/nmi.py``)."""


def read(facts):
    scores = facts.get("nmi")
    return sum(scores) / len(scores) if scores else None
