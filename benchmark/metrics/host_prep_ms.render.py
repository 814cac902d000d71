"""host_prep_ms.render: the mean host window planning of a traced call,
`prep_ms` of `synthesize_clips_batched(timings=)` as the service records
it."""


def read(ctx):
    value = ctx.get("phases", {}).get("prep_ms")
    return None if value is None else float(value)
