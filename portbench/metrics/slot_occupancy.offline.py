"""Engine batching: seated slots over ``slots``, averaged over the
window's decode iterations (the engine's occupancy samples)."""


def read(rec):
    if rec.get("mode") != "saturated" or not rec["occupancy"]:
        return None
    return 100.0 * sum(rec["occupancy"]) / (len(rec["occupancy"])
                                           * rec["slots"])
