"""Certified solves per second: the lanes the program returned SOLVED and the
reference certifies at the tolerance, over every call of the window, per
second of the window's wall clock."""


def read(window, verdict, ctx):
    return verdict.certified / window.host_s
