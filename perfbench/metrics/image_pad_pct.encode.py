"""Share of the rows the vision tower ran that were padding: the engine's
``encode.image_pad_rows`` over ``encode.image_rows`` (host counts, every
round of the run)."""


def read(run):
    counts = getattr(getattr(getattr(run.session, "engine", None), "tally", None), "counts", {})
    total = counts.get("encode.image_rows")
    return 100.0 * counts.get("encode.image_pad_rows", 0) / total if total else None
