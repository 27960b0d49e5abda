"""Comparisons of the program's answers with the plain reference's, one
module each, found by the names a configuration lists under ``answers``
(``["faces"]`` where it lists none); ``harness/check.py`` says what a
module gives."""
