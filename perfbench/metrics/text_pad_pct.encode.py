"""Share of the positions the text tower ran that were padding: the
engine's ``encode.text_pad_positions`` over ``encode.text_positions``
(host counts, every round of the run)."""


def read(run):
    counts = getattr(getattr(getattr(run.session, "engine", None), "tally", None), "counts", {})
    total = counts.get("encode.text_positions")
    return 100.0 * counts.get("encode.text_pad_positions", 0) / total if total else None
