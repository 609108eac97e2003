"""Inference passes an engine call of the window ran
(``InferenceEngine.passes``): above 1 where the speculated output bucket
was too small and the call ran again at the full budget."""


def read(record, sl):
    calls = record.get("calls")
    if not calls:
        return None
    return sum(c["passes"] for c in calls) / len(calls)
