"""Every query of the mix in one request, every request: ``{"name": "batch"}``."""


def requests(order: dict, qs: list, seed: int):
    while True:
        yield list(range(len(qs)))


def warmup(order: dict, qs: list):
    return [list(range(len(qs)))]
