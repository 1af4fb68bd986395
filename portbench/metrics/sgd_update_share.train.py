"""Trainer update: device seconds of the operations launched inside the
window's ``train.sgd_update`` spans over the window's busy seconds, in %
(``spans.sgd_update_share``). Traced runs only: they arm the spans."""

from portbench import spans


def read(rec):
    if rec.get("kind") != "train" or "timeline" not in rec:
        return None
    from tpu_cluster_torch import telemetry

    return spans.sgd_update_share(rec["timeline"], rec["spans"],
                                  telemetry.TRAIN_SPANS[2])
