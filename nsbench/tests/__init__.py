"""The benchmark's tests: CPU tests of the harness, and the card's under
the ``gpu`` marker."""
