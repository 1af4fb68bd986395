"""B*S tokens times the training steps completed in the window (ended by
a sync), over the window."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    return rec["steps"] * rec["tokens_per_step"] / rec["window_s"]
