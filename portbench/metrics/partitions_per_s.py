"""Member partitions detected in the window over its length: each round
of a job detects ``n_p`` and so does its final re-detection."""


def read(facts):
    return facts["partitions"] / facts["window_s"]
