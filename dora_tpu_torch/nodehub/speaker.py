"""Audio playback sink (dora_tpu/nodehub/speaker.py): every ``audio``
input played through ``sounddevice``; without an audio stack each chunk is
appended to a WAV file under ``SPEAKER_OUT`` instead, so the speech path
stays testable end to end.

Env: ``SAMPLE_RATE`` (default 16000), ``SPEAKER_OUT`` (default
``speaker-out``).
"""

from __future__ import annotations

import os
import wave
from pathlib import Path

import numpy as np

from dora_tpu_torch.node import Node


def _as_float_wave(value, metadata=None) -> np.ndarray:
    import pyarrow as pa

    from dora_tpu_torch.tpu.bridge import arrow_to_host

    if isinstance(value, pa.Array):
        wave_arr = np.asarray(arrow_to_host(value, metadata)).reshape(-1)
    else:
        wave_arr = np.frombuffer(bytes(value), dtype=np.float32)
    if wave_arr.dtype == np.int16:
        return wave_arr.astype(np.float32) / 32768.0
    return wave_arr.astype(np.float32)


def main() -> None:
    sample_rate = int(os.environ.get("SAMPLE_RATE", "16000"))
    out_dir = Path(os.environ.get("SPEAKER_OUT", "speaker-out"))

    stream = None
    try:
        import sounddevice

        stream = sounddevice.OutputStream(
            samplerate=sample_rate, channels=1, dtype="float32"
        )
        stream.start()
    except Exception:
        stream = None

    writer = None
    chunks = 0
    try:
        with Node() as node:
            for event in node:
                if event["type"] == "STOP":
                    break
                if event["type"] != "INPUT":
                    continue
                samples = _as_float_wave(event["value"], event["metadata"])
                if stream is not None:
                    stream.write(samples.reshape(-1, 1))
                else:
                    if writer is None:
                        out_dir.mkdir(parents=True, exist_ok=True)
                        writer = wave.open(str(out_dir / "speech.wav"), "wb")
                        writer.setnchannels(1)
                        writer.setsampwidth(2)
                        writer.setframerate(sample_rate)
                    pcm = (np.clip(samples, -1.0, 1.0) * 32767).astype("<i2")
                    writer.writeframes(pcm.tobytes())
                chunks += 1
    finally:
        if writer is not None:
            writer.close()
        if stream is not None:
            stream.stop()
            stream.close()
    print(f"played {chunks} chunks", flush=True)


if __name__ == "__main__":
    main()
