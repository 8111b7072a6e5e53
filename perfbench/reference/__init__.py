"""The plain references: the semantics each system is judged by, independent of the program."""
