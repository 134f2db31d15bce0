"""Host milliseconds an update that the loop's thread waits in the
prefetcher's ``__next__`` (the input path: collation, staging), the mean
over the window's unprofiled updates."""


def read(record):
    waits = record.get("input_wait_s")
    if record.get("kind") != "train" or not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
