"""The yardstick's arithmetic, frozen: operations and bytes counted from
shapes, and the card's published peaks. Nothing here reads the program."""
