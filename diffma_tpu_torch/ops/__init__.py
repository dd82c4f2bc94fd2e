"""Scan orders, mixer glue ops and the selective scan."""
