"""Structured-output grading schemas, on dataclasses.

Counterpart of `reflectionflow_tpu/verifiers/schemas.py`, which builds them
on pydantic: the same classes, fields and field order per GenEval tag, so
JSONL artifacts and `choice_of_metric` lookups match. Each schema class has
the three methods of the pydantic interface the verifiers use:
`model_json_schema()` returns the dict pydantic returns for the JAX class
(the OpenAI request body embeds it), `model_validate(data)` checks a reply
with pydantic's lax rules for these field types, and `model_dump()` returns
the fields in declaration order.
"""

import dataclasses
import re
from dataclasses import dataclass

_JSON_TYPES = {int: "integer", str: "string"}
_INT_TEXT = re.compile(r"[+-]?\d+(\.0*)?")


def _lax_int(value) -> int:
    """pydantic's lax int: ints and bools, integral floats, and integral
    decimal strings (surrounding whitespace allowed)."""
    if isinstance(value, int):
        return int(value)
    if isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(value, str) and _INT_TEXT.fullmatch(value.strip()):
        return int(value.strip().split(".")[0])
    raise ValueError(f"not a valid integer: {value!r}")


def _title(name: str) -> str:
    return name.title().replace("_", " ")


class _Schema:
    """The pydantic surface of a grading schema (a dataclass subclass)."""

    @classmethod
    def field_names(cls) -> list[str]:
        return [f.name for f in dataclasses.fields(cls)]

    @classmethod
    def _object_schema(cls, defs: dict) -> dict:
        props = {}
        for f in dataclasses.fields(cls):
            if isinstance(f.type, type) and issubclass(f.type, _Schema):
                defs.setdefault(f.type.__name__, f.type._object_schema(defs))
                props[f.name] = {"$ref": f"#/$defs/{f.type.__name__}"}
            else:
                props[f.name] = {"title": _title(f.name), "type": _JSON_TYPES[f.type]}
        return {"properties": props, "required": cls.field_names(), "title": cls.__name__,
                "type": "object"}

    @classmethod
    def model_json_schema(cls) -> dict:
        defs: dict = {}
        body = cls._object_schema(defs)
        return {"$defs": defs, **body} if defs else body

    @classmethod
    def model_validate(cls, data):
        if not isinstance(data, dict):
            raise ValueError(f"{cls.__name__}: expected an object, got {type(data).__name__}")
        values = {}
        for f in dataclasses.fields(cls):
            if f.name not in data:
                raise ValueError(f"{cls.__name__}.{f.name}: field required")
            v = data[f.name]
            if isinstance(f.type, type) and issubclass(f.type, _Schema):
                values[f.name] = f.type.model_validate(v)
            elif f.type is int:
                values[f.name] = _lax_int(v)
            elif isinstance(v, str):
                values[f.name] = v
            else:
                raise ValueError(f"{cls.__name__}.{f.name}: not a valid string: {v!r}")
        return cls(**values)

    def model_dump(self) -> dict:
        return dataclasses.asdict(self)


# no postponed annotations in this module: the schema walk reads each
# field's class from `dataclasses.fields`
@dataclass
class Score(_Schema):
    score: int
    explanation: str


@dataclass
class Grading(_Schema):
    accuracy_to_prompt: Score
    creativity_and_originality: Score
    visual_quality_and_realism: Score
    consistency_and_cohesion: Score
    emotional_or_thematic_resonance: Score
    overall_score: Score


@dataclass
class GradingSingleObject(_Schema):
    object_completeness: Score
    detectability: Score
    occlusion_handling: Score
    overall_score: Score


@dataclass
class GradingTwoObject(_Schema):
    separation_clarity: Score
    individual_completeness: Score
    relationship_accuracy: Score
    overall_score: Score


@dataclass
class GradingCounting(_Schema):
    count_accuracy: Score
    object_uniformity: Score
    spatial_legibility: Score
    overall_score: Score


@dataclass
class GradingColors(_Schema):
    color_fidelity: Score
    contrast_effectiveness: Score
    multi_object_consistency: Score
    overall_score: Score


@dataclass
class GradingPosition(_Schema):
    position_accuracy: Score
    occlusion_management: Score
    perspective_consistency: Score
    overall_score: Score


@dataclass
class GradingColorAttr(_Schema):
    attribute_binding: Score
    contrast_effectiveness: Score
    material_consistency: Score
    overall_score: Score


TAG_SCHEMAS: dict[str | None, type[_Schema]] = {
    None: Grading,
    "single_object": GradingSingleObject,
    "two_object": GradingTwoObject,
    "counting": GradingCounting,
    "colors": GradingColors,
    "position": GradingPosition,
    "color_attr": GradingColorAttr,
}


def schema_for_tag(tag: str | None) -> type[_Schema]:
    return TAG_SCHEMAS.get(tag, Grading)


def axes_for_tag(tag: str | None) -> list[str]:
    return schema_for_tag(tag).field_names()
