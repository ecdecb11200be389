"""Training-side pieces of the port that serving already needs: the two
synthetic token streams of ``training/data.py``."""
