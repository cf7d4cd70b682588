"""Plain references of the port's configurations, each in a file of its
own that imports no op, kernel or placement code of the port."""
