"""update_share.train: the update's share of the window's epochs, from
``train_epoch``'s own ``update_s`` over ``wall_s`` (each phase ends in a
sync), in %."""


def read(record):
    epochs = record.get("epochs") or []
    if record.get("mode") != "train" or not epochs:
        return None
    return 100.0 * sum(e["update_s"] for e in epochs) / sum(e["wall_s"] for e in epochs)
