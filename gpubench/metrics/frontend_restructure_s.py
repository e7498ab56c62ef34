"""Seconds of the cold frontend's Graph Restructurer stage (core/restructure.py) at set-up."""
from gbench import readers


def read(rec):
    return readers.frontend_stage_s(rec, "restructure")
