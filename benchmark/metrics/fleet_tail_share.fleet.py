"""Fleet: the share of the fleet audits' walls that came after all but the
last of an audit's topic passes had ended (``fleet-pass`` spans of the
traced window): the wait on the last topic, a straggler where one topic
is much larger than the rest. Summed over the audits with two passes or
more."""


def read(layer: dict, config: dict):
    passes = layer.get("passes") or []
    tail = wall = 0.0
    for a, b in layer.get("audits", []):
        ends = sorted(end for start, end, _ in passes if a <= start and end <= b)
        if len(ends) >= 2:
            tail += b - ends[-2]
            wall += b - a
    return tail / wall if wall > 0 else None
