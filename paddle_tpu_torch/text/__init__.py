"""``paddle.text``: NLP datasets (counterpart: paddle_tpu/text)."""
from . import datasets  # noqa: F401
from .datasets import (Conll05st, Imdb, Imikolov, Movielens, UCIHousing,
                       WMT14, WMT16)

__all__ = ["datasets", "Conll05st", "Imdb", "Imikolov", "Movielens",
           "UCIHousing", "WMT14", "WMT16"]
