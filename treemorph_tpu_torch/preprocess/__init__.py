"""Preprocessing: cutting labeled clouds into rasters
(:mod:`.rasterize`)."""

from .rasterize import clean_stem, rasterize_clouds

__all__ = ["clean_stem", "rasterize_clouds"]
