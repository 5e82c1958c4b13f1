"""Request audio (the true 16 kHz samples of every request row) over the
audio the encoder ran (whole 30 s windows, counted where it runs), %, from
the program's counters over the process."""
from benchmark.spans import counts


def read(run):
    found = counts()
    if not found or not found.get("model.encoded_samples"):
        return None
    return 100.0 * found.get("align.audio_samples", 0) / found["model.encoded_samples"]
