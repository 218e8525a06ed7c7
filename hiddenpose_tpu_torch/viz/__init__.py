"""Figures: the reference's volume, three-view, skeleton and heatmap
plots (``viz/visualizer.py``, ``viz/heatmap3d.py``).  matplotlib is
imported where a figure is drawn, never at import."""
