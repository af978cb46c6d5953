"""serve.request_s: seconds a served job spends outside the pipeline, from the
POST to the end of its chunked log, less the span from the first phase's
entry to the last phase's exit (the request's parsing, the job's set-up
before its first load, the log's streaming after its last save)."""


def read(rec):
    spans = [(j1 - j0) - (last - first) for j0, j1, first, last in rec["spans"]
             if first is not None]
    return sum(spans) / len(spans) if spans else None
