"""Microbenchmarks of the card that the port's bounds rest on."""
