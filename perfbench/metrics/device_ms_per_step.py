"""Milliseconds a trained step holds the card under the trainer: each chunk
of the window on the card, from its first step's input copies (once its
batch is there) to the end of its last step, by CUDA events on the
training stream, summed over the window's chunks and divided by its steps.
The waits for the loader between chunks are left out; the host's dispatch
inside a chunk, where the card waits for it, is in."""


def read(record):
    if not record.chunk_ms or not record.steps:
        return None
    return sum(record.chunk_ms) / record.steps
