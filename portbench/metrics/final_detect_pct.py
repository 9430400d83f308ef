"""Share of the window spent in final re-detections: from a job's last
round (its ``on_round`` hook, after the round's stats readback) to
``run_consensus``'s return with the host labels.  0 where the window
closed before a job's final re-detection ended in it."""


def read(facts):
    spent = facts.get("final_detect_s")
    return None if spent is None else 100.0 * spent / facts["window_s"]
