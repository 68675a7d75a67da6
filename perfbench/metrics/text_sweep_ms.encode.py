"""Median host milliseconds of a round's two caption sweeps
(``EncodingEngine.encode_texts``, each ending in its device barrier)."""

from perfbench.readers import span_ms


def read(run):
    return span_ms(run, "text_sweep")
