"""Requests over batch rows run by the engine in the window (a short
batch is padded to its fixed shape), in percent."""


def read(record):
    if record.get("kind") != "answer" or not record.get("batch_rows"):
        return None
    return 100.0 * record["requests"] / record["batch_rows"]
