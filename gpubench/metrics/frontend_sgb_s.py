"""Seconds of the cold frontend's SGB stage (core/sgb.py, K3 on the card) at set-up."""
from gbench import readers


def read(rec):
    return readers.frontend_stage_s(rec, "sgb")
