"""Microphone capture node (dora_tpu/nodehub/microphone.py): float32
chunks of ``MAX_DURATION`` seconds through sounddevice, one per input.
Without an audio device it sends synthetic audio (tone bursts between near
silence), which gives the VAD and ASR something structured.
"""

from __future__ import annotations

import os
import time

import numpy as np

from dora_tpu_torch.node import Node


def main() -> None:
    sample_rate = int(os.environ.get("SAMPLE_RATE", "16000"))
    chunk_s = float(os.environ.get("MAX_DURATION", "0.5"))
    chunk = int(sample_rate * chunk_s)

    stream = None
    try:
        import sounddevice as sd

        stream = sd.InputStream(samplerate=sample_rate, channels=1, dtype="float32")
        stream.start()
    except Exception:
        stream = None

    deadline = time.time() + 10 if os.environ.get("CI") else None
    max_chunks = int(os.environ.get("MAX_CHUNKS", "0"))
    i = 0
    with Node() as node:
        for event in node:
            if event["type"] == "STOP":
                break
            if event["type"] != "INPUT":
                continue
            if stream is not None:
                audio, _ = stream.read(chunk)
                audio = audio[:, 0]
            else:
                t = np.arange(chunk) / sample_rate
                if i % 4 < 2:  # tone burst
                    audio = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
                else:  # near-silence
                    audio = (0.001 * np.random.randn(chunk)).astype(np.float32)
            i += 1
            node.send_output(
                "audio",
                audio,
                {"sample_rate": sample_rate, "shape": [chunk], "dtype": "float32"},
            )
            if deadline and time.time() > deadline:
                break
            if max_chunks and i >= max_chunks:
                break


if __name__ == "__main__":
    main()
