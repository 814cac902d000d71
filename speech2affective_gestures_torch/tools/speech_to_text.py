"""Offline speech transcription tooling.

Capability parity with reference `utils/speech_to_text.py`: split a speaker
corpus wav on silences and transcribe the chunks with Google speech
recognition. The pydub/speech_recognition dependencies are optional — the
module degrades to raising informative errors, and `transcribe_corpus`
accepts any callable transcriber so tests can inject a fake.
"""

from __future__ import annotations

import os
from os.path import join as jn


def split_on_silence_chunks(wav_path: str, min_silence_len: int = 500,
                            silence_thresh_delta: int = -14,
                            keep_silence: int = 250):
    """Silence-based chunking (ref utils/speech_to_text.py pydub usage)."""
    try:
        from pydub import AudioSegment
        from pydub.silence import split_on_silence
    except ImportError as e:
        raise RuntimeError("pydub is required for silence splitting") from e
    sound = AudioSegment.from_wav(wav_path)
    return split_on_silence(
        sound,
        min_silence_len=min_silence_len,
        silence_thresh=sound.dBFS + silence_thresh_delta,
        keep_silence=keep_silence,
    )


def google_transcriber():
    try:
        import speech_recognition as sr
    except ImportError as e:
        raise RuntimeError("speech_recognition is required") from e
    recognizer = sr.Recognizer()

    def transcribe(chunk_wav_path: str) -> str:
        with sr.AudioFile(chunk_wav_path) as source:
            audio = recognizer.record(source)
        try:
            return recognizer.recognize_google(audio)
        except sr.UnknownValueError:
            return ""

    return transcribe


def transcribe_corpus(wav_dir: str, out_dir: str, transcriber=None,
                      chunker=split_on_silence_chunks):
    """Transcribe every wav in a directory into <name>.txt transcripts."""
    transcriber = transcriber or google_transcriber()
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    for name in sorted(os.listdir(wav_dir)):
        if not name.endswith(".wav"):
            continue
        base = name[:-4]
        chunks = chunker(jn(wav_dir, name))
        texts = []
        for i, chunk in enumerate(chunks):
            chunk_path = jn(out_dir, f"{base}_chunk{i}.wav")
            chunk.export(chunk_path, format="wav")
            texts.append(transcriber(chunk_path))
            os.remove(chunk_path)
        transcript = " ".join(t for t in texts if t)
        with open(jn(out_dir, base + ".txt"), "w") as f:
            f.write(transcript)
        results[base] = transcript
    return results


def estimate_word_timings(sentence: str, duration: float,
                          tts_renderer=None) -> list[list]:
    """Per-word [word, start, end] timing estimation.

    The reference renders the sentence and each word with pyttsx3 and uses
    the rendered lengths as duration proxies (loader_v2.py:54-99); without a
    TTS engine we fall back to character-length proportional allocation,
    which is the same estimator up to the synthesizer's pacing.
    """
    words = sentence.split()
    if not words:
        return []
    if tts_renderer is not None:
        lengths = [max(tts_renderer(w), 1e-3) for w in words]
    else:
        lengths = [max(len(w), 1) for w in words]
    total = float(sum(lengths))
    timings, t = [], 0.0
    for word, ln in zip(words, lengths):
        dt = duration * ln / total
        timings.append([word, t, t + dt])
        t += dt
    return timings
