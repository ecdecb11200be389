"""Plain references that decide ``correct``; each imports torch alone.

A configuration names its reference (``"reference"``), a module of this
package with a ``knn`` function.
"""
