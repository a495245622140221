"""service.separate_wav_ms.p50: the median server-side time of
`SeparationService.separate_wav` (the wait for the service's lock, the WAV
parse, the separation and the copy of the stems to the host), from the
benchmark's subclass of the service, over the measured window."""

import statistics


def read(run):
    d = run.spans.durations_s("service.separate_wav")
    return statistics.median(d) * 1e3 if d else None
