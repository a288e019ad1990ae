from .generator import FakeReflector, Reflector, load_reflector  # noqa: F401
from .refiner import FakeRefiner, Refiner, load_refiner  # noqa: F401
