"""Tokens the engine emitted in the window (the change of its
``decoded_tokens``), over the window."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return rec["decoded_in_window"] / rec["window_s"]
