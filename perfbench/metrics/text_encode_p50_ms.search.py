"""Median host milliseconds of a request's query encode
(``EncodingEngine.encode_texts`` inside ``search_texts``)."""

from perfbench.readers import span_ms


def read(run):
    return span_ms(run, "text_encode")
