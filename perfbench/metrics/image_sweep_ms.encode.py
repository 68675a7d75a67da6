"""Median host milliseconds of a round's image sweep
(``EncodingEngine.encode_images_cached``, ending in its device barrier)."""

from perfbench.readers import span_ms


def read(run):
    return span_ms(run, "image_sweep")
