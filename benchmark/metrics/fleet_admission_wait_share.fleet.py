"""Fleet: the topics' waits for a grant over the window
(``kta_fleet_admission_wait_seconds_total``, span ``fleet-admit``) over the
summed walls of their passes (``kta_fleet_pass_seconds_total``, span
``fleet-pass``)."""


def read(layer: dict, config: dict):
    c = layer["counters"]
    passes = c.get("kta_fleet_pass_seconds_total", 0.0)
    if passes <= 0 or "kta_fleet_admission_wait_seconds_total" not in c:
        return None
    return c["kta_fleet_admission_wait_seconds_total"] / passes
