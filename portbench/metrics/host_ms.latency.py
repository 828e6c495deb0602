"""Mean over the traced slice's requests of the request span less
the device time inside it, ms."""


def read(run):
    return None if run.slice is None else run.slice.host_ms()
