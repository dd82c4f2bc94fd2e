"""Datasets: ``.npy`` triplets and synthetic ones, the batch loader, the
native C++ loader's binding (``native.py``) and the dataset splitter
(``split.py``)."""
