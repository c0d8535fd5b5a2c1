"""Plain references the benchmark checks the program against."""
