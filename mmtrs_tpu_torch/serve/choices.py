"""UI dropdown choice maps (the port's copy of ``mmtrs_tpu.serve.choices``,
ui/gradio_app/app.py:50-86 CHOICES_MAP).

Kept in the port so that it imports nothing of the JAX package;
tests/test_torch_hygiene.py holds the two to the same maps, and
tests/test_torch_app.py to the same threshold modes.
"""

CHOICES_MAP: dict[str, dict[str, int]] = {
    "depth": {"≤ 4mm": 0, "> 4mm": 1},
    "width": {"< 1mm": 0, "≥ 1mm": 1},
    "enamel_cracks": {"No": 0, "Yes": 1},
    "occlusal_load": {"No": 0, "Yes": 1},
    "carious_lesion": {"Low risk": -1, "Moderate risk": 0, "High risk": 1},
    "opposing_type": {
        "Natural tooth": 0,
        "Missing": 1,
        "Fixed partial denture (FPD)": 2,
        "Implant": 3,
    },
    "adjacent_teeth": {"Presence from one side": 0, "Presence (both sides)": 1},
    "age_range": {"< 20 years": 0, "20-60 years": 1},
    "cervical_lesion": {"No": 0, "Yes": 1},
}

FIELD_ORDER = list(CHOICES_MAP.keys())

THRESHOLD_MODES = ["max_f1", "max_acc", "youden", "target_prec", "target_rec"]


def encode_fields(fields: dict[str, str]) -> list[float]:
    """Map UI labels → numeric encodings, preserving field order."""
    return [float(CHOICES_MAP[k][fields[k]]) for k in FIELD_ORDER]


def validate_all_or_none(fields: dict[str, str | None]) -> tuple[bool, list[str]]:
    """All-or-none tabular contract (app.py:298-318): either every field is
    provided or none are. Returns (use_tabular, missing)."""
    provided = [k for k in FIELD_ORDER if fields.get(k)]
    if not provided:
        return False, []
    missing = [k for k in FIELD_ORDER if not fields.get(k)]
    return len(missing) == 0, missing
