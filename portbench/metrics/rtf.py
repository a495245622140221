"""rtf: audio seconds completed in the measured window / its seconds. A
call counts its track's seconds; a block step counts 5.944 s (256 hops of
1024 samples at 44.1 kHz) for each stream; an upload answered counts its
clip's seconds, and the upload window closes when the last request sent
in it has been answered. None where nothing was completed."""


def read(run):
    w = run.window
    if not w.audio_s:
        return None
    return w.audio_s / w.window_s
