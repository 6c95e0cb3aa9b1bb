"""Plain references, one module a kind of system; they import nothing of the program."""
