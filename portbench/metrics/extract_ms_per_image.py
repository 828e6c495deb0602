"""Device ms an image of the extractor forward, from CUDA events around
the forward that the harness hands to make_end_to_end."""


def read(run):
    return run.entry.extract_ms()
